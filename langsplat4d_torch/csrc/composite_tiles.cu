// Tile-list compositor for NVIDIA Hopper (sm_90a): the forward of the
// training path's analytic VJP.
//
// Replaces the TPU kernel langsplat4d/ops/tile_composite.py:_composite_kernel
// (entry composite_tiles_pallas). Each tile blends the first counts[t] rows
// of its padded front-to-back list rows[t, 0:K, :] and writes
// accum[t, 0:C, px] (features; bg * T added to rgb) and accum[t, C, px]
// (the alpha sum, 1 - T).
//
// Design: one block of 256 threads per 16x16 tile, one thread per pixel,
// over rows[t, 0:min(counts[t], K)] with the forward walk of
// composite_common.cuh, the stream-layout forward's, so padded slots are
// never read. Rows are held row-major, [T, K, PW], so a pass over a tile's
// rows is one contiguous run (the TPU kernel keeps [T, PW, K] to put K on
// its lanes). The lists are cut from the sorted stream with no ellipse cull
// (the JAX package's `bin_tiles` has none), so they carry rows that no pixel
// of the tile blends: with hard cutoffs the walk's cover test is the tile
// test (`quadrant_covered` with the whole tile as the rect), and only the
// kept rows are compacted, in depth order, and blended; a dropped row is one
// that every pixel would skip by the blend's own rule, so the output is the
// same bit for bit. Each pixel stops for good before the first Gaussian
// that would take T below 1e-4, and the block leaves its list once every
// pixel has stopped.
//
// What bounds it: arithmetic, not bytes. A (Gaussian, pixel) pair costs one
// expf and ~20 + 2C fp32 operations, against one PW-float row per Gaussian
// shared by 256 pixels; the time is the per-pixel dependent chain times the
// walked list length, and the early exit is what cuts it.

#include "composite_common.cuh"

namespace {

using namespace ls4d;

// Four blocks an SM at row width 16 (64 registers, no spill), with a kept
// row's features loaded right after its tile test; three blocks with the
// later gather were slower.
template <int PW>
__global__ void __launch_bounds__(BLOCK_PX, PW == 16 ? 4 : 2)
composite_tiles_kernel(const float* __restrict__ rows,
                       const int* __restrict__ counts,
                       const float* __restrict__ bg,
                       float* __restrict__ out,
                       int K, int tiles_x, int hard) {
  constexpr int C = PW - HDR;
  const int tile = blockIdx.x;
  const int pixel = block_pixel(threadIdx.x);
  const float ox = static_cast<float>((tile % tiles_x) * QUAD);
  const float oy = static_cast<float>((tile / tiles_x) * QUAD);

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float asum = 0.0f;
  bool done = false;
  const RectCover cover{ox, oy, ox, oy, hard != 0};
  forward_walk<PW, FWD_PASS, true>(
      rows + static_cast<size_t>(tile) * K * PW, min(counts[tile], K), ox, oy,
      PixelBasis(pixel % QUAD, pixel / QUAD), cover, hard, &T, acc, &asum,
      &done);

  float* o = out + static_cast<size_t>(tile) * (C + 1) * BLOCK_PX +
             pixel_after_walk();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    o[c * BLOCK_PX] = c < 3 ? acc[c] + bg[c] * T : acc[c];
  }
  o[C * BLOCK_PX] = asum;
}

}  // namespace

// rows [T, K, PW] (16-byte aligned), counts [T], bg [3] -> out
// [T, PW - 8 + 1, 256]. Launches on `stream`; returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for a row width the kernel does not
// take.
extern "C" int ls4d_composite_tiles(const float* rows, const int* counts,
                                    const float* bg, float* out,
                                    int num_tiles, int K, int tiles_x, int pw,
                                    int hard_cutoffs, cudaStream_t stream) {
  if (num_tiles <= 0) return cudaSuccess;
  const dim3 grid(num_tiles);
  const dim3 block(BLOCK_PX);
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
