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
// Arithmetic follows the TPU kernel: power is the six per-Gaussian
// coefficients against the basis [1, x, y, x^2, y^2, xy], summed as an fmaf
// chain in basis order, and the coefficients use the same fused multiply-
// adds: this is what the JAX package's kernel computes on the CPU, bit for
// bit. At 32-px tiles the coefficient form loses up to ~3e-4 of power to
// cancellation (k0 reaches ~800 for a 1-px splat 40 px from the tile
// origin), so a different rounding anywhere shows as ~1e-4 in the image;
// the form is kept for parity with the reference. Built with
// --fmad=false and plain expf (no fast math) so that nothing else fuses: the
// operations and their order match composite_stream_plain in
// ops/composite.py, and the two agree on every power > 0 and alpha < 1/255
// test.

#include <cuda_runtime.h>

namespace {

constexpr int HDR = 8;       // header columns before the feature block
constexpr int BATCH = 256;   // rows staged per pass
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float MAX_ALPHA = 0.99f;

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
  const float x = static_cast<float>(lx);
  const float y = static_cast<float>(ly);
  const float xx = x * x, yy = y * y, xy = x * y;

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
    const float* src = rows + static_cast<size_t>(b0) * PW;
    for (int i = tid; i < nb * PW; i += nthreads) s_rows[i] = src[i];
    __syncthreads();
    for (int j = tid; j < nb; j += nthreads) {
      const float* r = s_rows + j * PW;
      const float mx = r[0] - ox;
      const float my = r[1] - oy;
      const float c0 = r[2], c1 = r[3], c2 = r[4];
      float* k = s_coef + j * 8;
      k[0] = fmaf(-0.5f, fmaf(c0 * mx, mx, c2 * my * my), -(c1 * mx * my));
      k[1] = fmaf(c1, my, c0 * mx);
      k[2] = fmaf(c2, my, c1 * mx);
      k[3] = -0.5f * c0;
      k[4] = -0.5f * c2;
      k[5] = -c1;
      k[6] = r[5];
    }
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < nb; ++j) {
      const float* k = s_coef + j * 8;
      float power = k[0];
      power = fmaf(k[1], x, power);
      power = fmaf(k[2], y, power);
      power = fmaf(k[3], xx, power);
      power = fmaf(k[4], yy, power);
      power = fmaf(k[5], xy, power);
      if (power > 0.0f) continue;
      const float alpha = fminf(MAX_ALPHA, expf(power + k[6]));
      if (hard && alpha < ALPHA_MIN) continue;
      const float test_T = T * (1.0f - alpha);
      if (hard && test_T < T_EPS) {
        done = true;
        break;
      }
      const float w = alpha * T;
      const float* f = s_rows + j * PW + HDR;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = acc[c] + f[c] * w;
      asum = asum + w;
      T = test_T;
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

extern "C" const char* ls4d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
