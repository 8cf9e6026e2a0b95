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
// What bounded the first version on this card: the shape of its walk, not
// the arithmetic or the bytes. It reduced each of a Gaussian's 6 + C sums
// with a butterfly of its own (70 shuffles and 70 adds per warp and
// Gaussian at row width 16, a sixth of its time when measured), wrote a
// warp's zero partials for every Gaussian that none of its pixels reached,
// let warps whose pixels had all stopped walk on, and after every 32 rows
// left the sums over the warps and the row's 64 bytes to 32 of its 256
// threads.
//
// Design: one block per 16x16 tile, one thread per pixel; the walk is
// `backward_walk` of composite_common.cuh, which the tile-list backward
// shares. There a Gaussian's sums cross the warp together in one
// transposed exchange (16 shuffles for 70; 31 for 110 and 150 at row
// widths 24 and 32), untouched (warp, Gaussian) pairs are a bit in a mask,
// a warp is an 8x4 patch of pixels so that fewer warps are touched, stopped
// warps skip the batch, the expf of a pair far below the alpha cutoff is
// skipped, S / (1 - alpha) is a multiply by the approximate reciprocal,
// coefficients and features are 16-byte loads, rows are staged 64 at a time
// (row width 16) with one barrier, and all 256 threads add the warps'
// partials and store the rows as whole lines. The order of every sum is
// fixed. d_rows comes uninitialised:
// a block that leaves early (all its pixels stopped) zeroes the rest of its
// segment, and an empty segment writes nothing. Row offsets are 64-bit: a
// segment has no capacity.
//
// What bounds it now: the latency of the walk. A pixel's T, prefix, expf
// and division and the five shuffle stages of a Gaussian's reduction are one
// dependent chain per warp, the warps of a tile reach a Gaussian unevenly
// (about half of them at all, on the training-step workload), and a slot of
// a long segment is walked by the few pixels that have not stopped. The
// stream holds only the pairs that the ellipse cull left, so fewer of them
// are skipped after their alpha than in the lists.

#include "composite_common.cuh"

namespace {

using namespace ls4d;

// At row width 16 ptxas is held to the 64 registers that let an SM hold four
// blocks (left alone it takes 71 for the stream layout's kernel, and the SM
// holds three); the wider rows need more registers than that.
template <int PW>
__global__ void __launch_bounds__(BLOCK_PX, PW == 16 ? 4 : 1)
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
      static_cast<float>((tile % tiles_x) * QUAD),
      static_cast<float>((tile / tiles_x) * QUAD),
      g_out + static_cast<size_t>(tile) * (C + 1) * BLOCK_PX +
          block_pixel(tid),
      total_in[static_cast<size_t>(tile) * BLOCK_PX + block_pixel(tid)],
      d_rows + first,
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
  const dim3 block(BLOCK_PX);
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
