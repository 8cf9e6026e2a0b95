// Backward of the stream-layout training compositor for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// langsplat4d/ops/tile_composite.py:_stream_chunk_bwd_kernel (entry
// composite_stream_chunks_backward_pallas). Each tile re-walks its segment
// rows[starts[t] : starts[t+1]] front to back with the forward's
// recurrences and writes one gradient row per slot of the stream:
// d_rows[s, :] = [dmx, dmy, dc0, dc1, dc2, d_op, 0, 0, d_feat_0 ..] (d_op,
// not d_ln_op, so the rows land on the caller's packed layout). The caller
// scatter-adds the rows to the Gaussians.
//
// The TPU kernel carries T and the prefix of w * phi across a tile's chunks
// in scratch memory, and needs the chunk-aligned stream so that a
// sequential grid can write gradient rows without conflicts. Here a slot of
// the stream belongs to exactly one tile and one block owns that tile, so
// every slot's row is written by one thread of one block: no atomics
// whatever the alignment, and T and the prefix are registers of the pixel's
// thread over the whole segment.
//
// Design: one block per 16x16 tile, one thread per pixel; the walk, with its
// warp-shuffle reductions and fixed sum order, is `backward_walk` of
// composite_common.cuh, which the tile-list backward shares. d_rows comes
// uninitialised: a block that leaves early (all its pixels stopped) zeroes
// the rest of its segment, and an empty segment writes nothing. Row offsets
// are 64-bit: a segment has no capacity.
//
// What bounds it: arithmetic and shuffles, as the tile-list backward: a
// (Gaussian, pixel) pair costs the forward's work plus ~6 + 2C operations
// and 5 (6 + C) shuffle-adds, against one row read and one row written per
// slot shared by 256 pixels. The stream holds only the pairs that the
// ellipse cull left, so fewer of them are skipped after their alpha than in
// the lists.

#include "composite_common.cuh"

namespace {

using namespace ls4d;

template <int PW>
__global__ void __launch_bounds__(BWD_PX)
composite_stream_chunks_backward_kernel(const float* __restrict__ rows,
                                        const int* __restrict__ starts,
                                        const float* __restrict__ g_out,
                                        const float* __restrict__ total_in,
                                        float* __restrict__ d_rows,
                                        int tiles_x, int hard) {
  constexpr int C = PW - HDR;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int seg_begin = starts[tile];
  const int count = starts[tile + 1] - seg_begin;
  const size_t first = static_cast<size_t>(seg_begin) * PW;
  backward_walk<PW>(
      rows + first, count, count,
      static_cast<float>((tile % tiles_x) * BWD_TILE),
      static_cast<float>((tile / tiles_x) * BWD_TILE),
      g_out + static_cast<size_t>(tile) * (C + 1) * BWD_PX + tid,
      total_in[static_cast<size_t>(tile) * BWD_PX + tid], d_rows + first,
      hard);
}

}  // namespace

// rows [B, PW], starts [T + 1], g_out [T, PW - 8 + 1, 256], total [T, 256]
// -> d_rows [B, PW] (rows of [starts[0], starts[T]) are written). Launches
// on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a row width the kernel does not take.
extern "C" int ls4d_composite_stream_chunks_backward(
    const float* rows, const int* starts, const float* g_out,
    const float* total, float* d_rows, int num_tiles, int tiles_x, int pw,
    int hard_cutoffs, cudaStream_t stream) {
  if (num_tiles <= 0) return cudaSuccess;
  const dim3 grid(num_tiles);
  const dim3 block(BWD_PX);
  switch (pw) {
    case 16:
      composite_stream_chunks_backward_kernel<16><<<grid, block, 0, stream>>>(
          rows, starts, g_out, total, d_rows, tiles_x, hard_cutoffs);
      break;
    case 24:
      composite_stream_chunks_backward_kernel<24><<<grid, block, 0, stream>>>(
          rows, starts, g_out, total, d_rows, tiles_x, hard_cutoffs);
      break;
    case 32:
      composite_stream_chunks_backward_kernel<32><<<grid, block, 0, stream>>>(
          rows, starts, g_out, total, d_rows, tiles_x, hard_cutoffs);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
