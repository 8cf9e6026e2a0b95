// Stream compositor for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel langsplat4d/ops/tile_composite.py:_stream_kernel
// (entry composite_stream_pallas). Each tile blends its segment
// [starts[t], starts[t+1]) of the (tile, depth)-sorted row stream front to
// back and writes the [C+1, H, W] image directly, which fuses the TPU path's
// [T, C+1, px] stitch and crop.
//
// Design: one block per tile, one thread per pixel (16x16 or 32x32). The
// block stages its segment through shared memory BATCH rows at a time with
// coalesced loads, and one thread per staged row turns its header into the
// quadratic coefficients of the Gaussian's power over the tile-local pixel
// basis, so every pixel reads them as shared-memory broadcasts. Each pixel
// walks front to back; with hard cutoffs it stops before the first Gaussian
// that would take T below 1e-4, and the block leaves its segment once
// __syncthreads_count shows every pixel done. Pixels beyond the image edge
// help with the loads and write nothing.
//
// What bounds it: arithmetic, not bytes. A (Gaussian, pixel) pair costs
// ~20 fp32 operations and one expf against one 64-byte row per Gaussian per
// tile shared by 256-1024 pixels, so the rows stream far below the HBM rate
// and the time is the per-pixel dependent chain (T carries from one Gaussian
// to the next) times the segment length; the early exit is what cuts it.
//
// Arithmetic (composite_common.cuh) follows the TPU kernel: this is what the
// JAX package's kernel computes on the CPU, bit for bit. At 32-px tiles the
// coefficient form loses up to ~3e-4 of power to cancellation (k0 reaches
// ~800 for a 1-px splat 40 px from the tile origin), so a different rounding
// anywhere shows as ~1e-4 in the image; the form is kept for parity with the
// reference. The operations and their order match composite_stream_plain in
// ops/composite.py.

#include "composite_common.cuh"

namespace {

using namespace ls4d;

constexpr int BATCH = 256;   // rows staged per pass

template <int PW>
__global__ void __launch_bounds__(1024)
composite_stream_kernel(const float* __restrict__ rows,
                        const int* __restrict__ starts,
                        const float* __restrict__ bg,
                        float* __restrict__ out,
                        int tiles_x, int tile_size, int height, int width,
                        int hard) {
  constexpr int C = PW - HDR;
  __shared__ float s_rows[BATCH * PW];
  __shared__ float s_coef[BATCH * 8];  // k0..k5, ln_op, unused

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int lx = tid % tile_size;
  const int ly = tid / tile_size;
  const int px = tx * tile_size + lx;
  const int py = ty * tile_size + ly;
  const bool inside = px < width && py < height;
  const float ox = static_cast<float>(tx * tile_size);
  const float oy = static_cast<float>(ty * tile_size);
  const PixelBasis basis(lx, ly);

  const int seg_begin = starts[tile];
  const int seg_end = starts[tile + 1];

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float asum = 0.0f;
  bool done = !inside;

  for (int b0 = seg_begin; b0 < seg_end; b0 += BATCH) {
    const int nb = min(BATCH, seg_end - b0);
    // barrier before the staging buffers are overwritten; with hard cutoffs
    // it also counts the pixels still blending
    if (hard) {
      if (__syncthreads_count(!done) == 0) break;
    } else {
      __syncthreads();
    }
    stage_rows<PW>(rows + static_cast<size_t>(b0) * PW, nb, ox, oy, s_rows,
                   s_coef, tid, nthreads);
    if (!done) {
      blend_staged<PW>(s_rows, s_coef, nb, basis, hard, &T, acc, &asum, &done);
    }
  }

  if (!inside) return;
  const size_t plane = static_cast<size_t>(height) * width;
  const size_t pix = static_cast<size_t>(py) * width + px;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    out[c * plane + pix] = c < 3 ? acc[c] + bg[c] * T : acc[c];
  }
  out[C * plane + pix] = asum;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a row width or tile size the kernel does not take.
extern "C" int ls4d_composite_stream(const float* rows, const int* starts,
                                     const float* bg, float* out,
                                     int num_tiles, int tiles_x,
                                     int tile_size, int height, int width,
                                     int pw, int hard_cutoffs,
                                     cudaStream_t stream) {
  if (tile_size != 16 && tile_size != 32) return cudaErrorInvalidValue;
  if (num_tiles <= 0) return cudaSuccess;
  const dim3 grid(num_tiles);
  const dim3 block(tile_size * tile_size);
  switch (pw) {
    case 16:
      composite_stream_kernel<16><<<grid, block, 0, stream>>>(
          rows, starts, bg, out, tiles_x, tile_size, height, width,
          hard_cutoffs);
      break;
    case 24:
      composite_stream_kernel<24><<<grid, block, 0, stream>>>(
          rows, starts, bg, out, tiles_x, tile_size, height, width,
          hard_cutoffs);
      break;
    case 32:
      composite_stream_kernel<32><<<grid, block, 0, stream>>>(
          rows, starts, bg, out, tiles_x, tile_size, height, width,
          hard_cutoffs);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
