// Training forward over the (tile, depth)-sorted stream for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// langsplat4d/ops/tile_composite.py:_stream_chunk_fwd_kernel (entry
// composite_stream_chunks_pallas). Each tile blends its ragged segment
// rows[starts[t] : starts[t+1]] front to back and writes accum[t, 0:C, px]
// (features; bg * T added to rgb) and accum[t, C, px] (the alpha sum,
// 1 - T). A tile with an empty segment writes bg and a zero alpha.
//
// The TPU kernel runs a sequential grid over g-wide chunks of a
// chunk-aligned stream, each chunk owned by one tile, and carries T from one
// grid step to the next in scratch memory. Here blocks run in parallel, so
// one block owns one tile and loops over the tile's whole segment with T in
// a register of the pixel's thread: the stream needs no alignment, no
// padding slots and no chunk-to-tile table, only the segment bounds. With
// hard cutoffs a pixel stops for good before the first Gaussian that would
// take T below 1e-4 (the TPU kernel resumes it at the next chunk).
//
// Design: one block per 16x16 tile, one thread per pixel; the segment is
// staged through shared memory 256 rows at a time with coalesced loads and
// blended by the loop the other forward kernels use (composite_common.cuh);
// the block leaves its segment once __syncthreads_count shows every pixel
// done. A segment has no capacity, so it may span many batches; row offsets
// are 64-bit.
//
// What bounds it: arithmetic, not bytes. A (Gaussian, pixel) pair costs one
// expf and ~20 + 2C fp32 operations, against one PW-float row per Gaussian
// and tile shared by 256 pixels; the time is the per-pixel dependent chain
// times the walked segment length, and the early exit is what cuts it.

#include "composite_common.cuh"

namespace {

using namespace ls4d;

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;
constexpr int BATCH = 256;   // rows staged per pass

template <int PW>
__global__ void __launch_bounds__(PX)
composite_stream_chunks_kernel(const float* __restrict__ rows,
                               const int* __restrict__ starts,
                               const float* __restrict__ bg,
                               float* __restrict__ out,
                               int tiles_x, int hard) {
  constexpr int C = PW - HDR;
  __shared__ float s_rows[BATCH * PW];
  __shared__ float s_coef[BATCH * 8];  // k0..k5, ln_op, unused

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float ox = static_cast<float>((tile % tiles_x) * TILE);
  const float oy = static_cast<float>((tile / tiles_x) * TILE);
  const PixelBasis basis(tid % TILE, tid / TILE);
  const int seg_begin = starts[tile];
  const int count = starts[tile + 1] - seg_begin;
  const float* tile_rows = rows + static_cast<size_t>(seg_begin) * PW;

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float asum = 0.0f;
  bool done = false;

  for (int b0 = 0; b0 < count; b0 += BATCH) {
    const int nb = min(BATCH, count - b0);
    // barrier before the staging buffers are overwritten; with hard cutoffs
    // it also counts the pixels still blending
    if (hard) {
      if (__syncthreads_count(!done) == 0) break;
    } else {
      __syncthreads();
    }
    stage_rows<PW>(tile_rows + static_cast<size_t>(b0) * PW, nb, ox, oy,
                   s_rows, s_coef, tid, PX);
    if (!done) {
      blend_staged<PW>(s_rows, s_coef, nb, basis, hard, &T, acc, &asum, &done);
    }
  }

  float* o = out + static_cast<size_t>(tile) * (C + 1) * PX + tid;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    o[c * PX] = c < 3 ? acc[c] + bg[c] * T : acc[c];
  }
  o[C * PX] = asum;
}

}  // namespace

// rows [B, PW], starts [T + 1], bg [3] -> out [T, PW - 8 + 1, 256]. Launches
// on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a row width the kernel does not take.
extern "C" int ls4d_composite_stream_chunks(const float* rows,
                                            const int* starts,
                                            const float* bg, float* out,
                                            int num_tiles, int tiles_x,
                                            int pw, int hard_cutoffs,
                                            cudaStream_t stream) {
  if (num_tiles <= 0) return cudaSuccess;
  const dim3 grid(num_tiles);
  const dim3 block(PX);
  switch (pw) {
    case 16:
      composite_stream_chunks_kernel<16><<<grid, block, 0, stream>>>(
          rows, starts, bg, out, tiles_x, hard_cutoffs);
      break;
    case 24:
      composite_stream_chunks_kernel<24><<<grid, block, 0, stream>>>(
          rows, starts, bg, out, tiles_x, hard_cutoffs);
      break;
    case 32:
      composite_stream_chunks_kernel<32><<<grid, block, 0, stream>>>(
          rows, starts, bg, out, tiles_x, hard_cutoffs);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
