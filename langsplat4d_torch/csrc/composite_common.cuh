// What the three Hopper compositors share: the packed-row constants, the
// shared-memory row staging, the power chain and the forward's per-pixel
// blend.
//
// Row layout (PW floats): [pix_x, pix_y, conic0, conic1, conic2, ln_op, 0, 0,
// feat_0 .. feat_{PW-9}] -- the JAX package's kernel rows, row-major.
//
// Arithmetic follows the TPU kernels: power is the six per-Gaussian
// coefficients against the tile-local basis [1, x, y, x^2, y^2, xy], summed
// as an fmaf chain in basis order, with the coefficients formed by the same
// fused multiply-adds. Every kernel that includes this header is built with
// --fmad=false and plain expf, so nothing else fuses and the forward, the
// backward and the plain PyTorch versions agree on every power > 0 and
// alpha < 1/255 test.
//
// Each source that includes this header is built into a library of its own,
// so the one non-inline function here (the error string) is defined once per
// library.
#pragma once

#include <cuda_runtime.h>

namespace ls4d {

constexpr int HDR = 8;       // header columns before the feature block
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float MAX_ALPHA = 0.99f;

// Tile-local pixel coordinates and their products.
struct PixelBasis {
  float x, y, xx, yy, xy;
  __device__ __forceinline__ PixelBasis(int lx, int ly)
      : x(static_cast<float>(lx)), y(static_cast<float>(ly)) {
    xx = x * x;
    yy = y * y;
    xy = x * y;
  }
};

// Copies `nb` rows from `src` into s_rows with coalesced loads, then one
// thread per row turns its header into s_coef[8 * j + 0..6]: the quadratic
// coefficients k0..k5 of the Gaussian's power over the tile-local basis and
// ln_op. The caller has made sure that nobody still reads the buffers; on
// return every thread may read them.
template <int PW>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int nb, float ox, float oy,
                                           float* s_rows, float* s_coef,
                                           int tid, int nthreads) {
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
}

// The power of one staged Gaussian (its coefficients k = s_coef + 8 j) at
// one pixel. A Gaussian is skipped at a pixel where power > 0; otherwise
// alpha = min(0.99, expf(power + k[6])), skipped with hard cutoffs where
// alpha < 1/255. (The three lines of that rule are written out where they
// are used: returning alpha through a helper cost the forward kernels 13%.)
__device__ __forceinline__ float gaussian_power(const float* k,
                                                const PixelBasis& p) {
  float power = k[0];
  power = fmaf(k[1], p.x, power);
  power = fmaf(k[2], p.y, power);
  power = fmaf(k[3], p.xx, power);
  power = fmaf(k[4], p.yy, power);
  power = fmaf(k[5], p.xy, power);
  return power;
}

// One pixel blends the `nb` staged Gaussians front to back into (T, acc,
// asum). With hard cutoffs it stops for good before the first Gaussian that
// would take T below 1e-4, and says so in *done.
template <int PW>
__device__ __forceinline__ void blend_staged(const float* s_rows,
                                             const float* s_coef, int nb,
                                             const PixelBasis& p, int hard,
                                             float* T, float (&acc)[PW - HDR],
                                             float* asum, bool* done) {
  for (int j = 0; j < nb; ++j) {
    const float* k = s_coef + j * 8;
    const float power = gaussian_power(k, p);
    if (power > 0.0f) continue;
    const float alpha = fminf(MAX_ALPHA, expf(power + k[6]));
    if (hard && alpha < ALPHA_MIN) continue;
    const float test_T = *T * (1.0f - alpha);
    if (hard && test_T < T_EPS) {
      *done = true;
      return;
    }
    const float w = alpha * *T;
    const float* f = s_rows + j * PW + HDR;
#pragma unroll
    for (int c = 0; c < PW - HDR; ++c) acc[c] = acc[c] + f[c] * w;
    *asum = *asum + w;
    *T = test_T;
  }
}

}  // namespace ls4d

extern "C" const char* ls4d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
