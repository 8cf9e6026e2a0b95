// Tile-list compositor for NVIDIA Hopper (sm_90a): the forward of the
// training path's analytic VJP.
//
// Replaces the TPU kernel langsplat4d/ops/tile_composite.py:_composite_kernel
// (entry composite_tiles_pallas). Each tile blends the first counts[t] rows
// of its padded front-to-back list rows[t, 0:K, :] and writes
// accum[t, 0:C, px] (features; bg * T added to rgb) and accum[t, C, px]
// (the alpha sum, 1 - T).
//
// Design: one block per 16x16 tile, one thread per pixel. Rows are held
// row-major, [T, K, PW], so a batch of a tile's rows is one contiguous run
// that the block stages through shared memory with coalesced loads (the TPU
// kernel keeps [T, PW, K] to put K on its lanes). Each pixel walks front to
// back and, with hard cutoffs, stops for good before the first Gaussian that
// would take T below 1e-4; the block leaves its list once
// __syncthreads_count shows every pixel done or counts[t] is reached, so
// padded slots are never read.
//
// What bounds it: arithmetic, not bytes. A (Gaussian, pixel) pair costs one
// expf and ~20 + 2C fp32 operations, against one PW-float row per Gaussian
// shared by 256 pixels; the time is the per-pixel dependent chain times the
// walked list length, and the early exit is what cuts it.

#include "composite_common.cuh"

namespace {

using namespace ls4d;

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;
constexpr int BATCH = 256;   // rows staged per pass

template <int PW>
__global__ void __launch_bounds__(PX)
composite_tiles_kernel(const float* __restrict__ rows,
                       const int* __restrict__ counts,
                       const float* __restrict__ bg,
                       float* __restrict__ out,
                       int K, int tiles_x, int hard) {
  constexpr int C = PW - HDR;
  __shared__ float s_rows[BATCH * PW];
  __shared__ float s_coef[BATCH * 8];  // k0..k5, ln_op, unused

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float ox = static_cast<float>((tile % tiles_x) * TILE);
  const float oy = static_cast<float>((tile / tiles_x) * TILE);
  const PixelBasis basis(tid % TILE, tid / TILE);
  const int count = min(counts[tile], K);
  const float* tile_rows = rows + static_cast<size_t>(tile) * K * PW;

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

// rows [T, K, PW], counts [T], bg [3] -> out [T, PW - 8 + 1, 256]. Launches
// on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a row width the kernel does not take.
extern "C" int ls4d_composite_tiles(const float* rows, const int* counts,
                                    const float* bg, float* out,
                                    int num_tiles, int K, int tiles_x, int pw,
                                    int hard_cutoffs, cudaStream_t stream) {
  if (num_tiles <= 0) return cudaSuccess;
  const dim3 grid(num_tiles);
  const dim3 block(PX);
  switch (pw) {
    case 16:
      composite_tiles_kernel<16><<<grid, block, 0, stream>>>(
          rows, counts, bg, out, K, tiles_x, hard_cutoffs);
      break;
    case 24:
      composite_tiles_kernel<24><<<grid, block, 0, stream>>>(
          rows, counts, bg, out, K, tiles_x, hard_cutoffs);
      break;
    case 32:
      composite_tiles_kernel<32><<<grid, block, 0, stream>>>(
          rows, counts, bg, out, K, tiles_x, hard_cutoffs);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
