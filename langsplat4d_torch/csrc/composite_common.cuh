// What the six Hopper compositors share: the packed-row constants, the
// shared-memory row staging, the power chain, the forward's per-pixel blend
// and the backward's walk over one 16x16 tile's rows.
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

// The header r of one row -> k[0..6]: the quadratic coefficients k0..k5 of
// the Gaussian's power over the pixel basis of the tile at (ox, oy), and
// ln_op.
__device__ __forceinline__ void row_coefficients(const float* r, float ox,
                                                 float oy, float* k) {
  const float mx = r[0] - ox;
  const float my = r[1] - oy;
  const float c0 = r[2], c1 = r[3], c2 = r[4];
  k[0] = fmaf(-0.5f, fmaf(c0 * mx, mx, c2 * my * my), -(c1 * mx * my));
  k[1] = fmaf(c1, my, c0 * mx);
  k[2] = fmaf(c2, my, c1 * mx);
  k[3] = -0.5f * c0;
  k[4] = -0.5f * c2;
  k[5] = -c1;
  k[6] = r[5];
}

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
    row_coefficients(s_rows + j * PW, ox, oy, s_coef + j * 8);
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

// ---- the backward's walk, shared by the tile-list and the stream layout ----

constexpr int BWD_TILE = 16;                 // the backward takes 16-px tiles
constexpr int BWD_PX = BWD_TILE * BWD_TILE;  // one thread per pixel
constexpr int BWD_WARPS = BWD_PX / 32;
constexpr int BWD_BATCH = 32;                // rows staged per pass

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block of 256 threads re-walks the `count` front-to-back rows at `src`
// for the 16x16 tile at (ox, oy) with the forward's recurrences and writes
// one gradient row per row to `dst`: [dmx, dmy, dc0, dc1, dc2, d_op, 0, 0,
// d_feat_0 ..]; rows [walked, zero_to) of `dst`, which the block did not
// reach, are zeroed. `g` points at this pixel's entry of the tile's
// cotangent [C + 1, 256]; `total` is <accum, g> of this pixel.
//
// Per pixel and Gaussian i (w_i = alpha_i T_i, T_{i+1} = T_i (1 - alpha_i)):
//   phi_i    = sum_c f_{i,c} g_c + g_alpha
//   prefix  += w_i phi_i;  S_i = total - prefix
//   d_alpha  = T_i phi_i - S_i / max(1 - alpha_i, 1e-6), zero where the
//              Gaussian is skipped, the pixel has stopped, or alpha is
//              clamped at 0.99
//   da       = d_alpha * alpha_i                    (= dL/dpower = dL/dln_op)
// and per Gaussian the sums over the tile's 256 pixels of da * basis[0..5]
// (the gradient of the six power coefficients; basis[0] = 1 gives d_ln_op)
// and of w_i g_c (the feature gradient). The 6 + C sums are reduced inside
// each warp with shuffles (a warp none of whose pixels the Gaussian reaches
// skips them), the 8 warps' partials go to shared memory, and after the
// batch thread j adds them in warp order, chains the coefficient gradients
// to (centre, conic, opacity) and writes row j. Pixels that have stopped
// keep taking part with zeros; the block leaves when all its pixels are
// done or `count` is reached.
template <int PW>
__device__ __forceinline__ void backward_walk(const float* __restrict__ src,
                                              int count, int zero_to,
                                              float ox, float oy,
                                              const float* __restrict__ g,
                                              float total,
                                              float* __restrict__ dst,
                                              int hard) {
  constexpr int C = PW - HDR;
  constexpr int V = 6 + C;     // sums per Gaussian
  constexpr int VP = V | 1;    // odd stride: thread j reads without conflicts
  __shared__ float s_rows[BWD_BATCH * PW];
  __shared__ float s_coef[BWD_BATCH * 8];
  __shared__ float s_part[BWD_WARPS * BWD_BATCH * VP];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const PixelBasis basis(tid % BWD_TILE, tid / BWD_TILE);

  float gf[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gf[c] = g[c * BWD_PX];
  const float g_alpha = g[C * BWD_PX];

  float T = 1.0f;
  float prefix = 0.0f;
  bool done = false;
  int walked = 0;

  for (int b0 = 0; b0 < count; b0 += BWD_BATCH) {
    const int nb = min(BWD_BATCH, count - b0);
    // barrier before the shared buffers are overwritten; with hard cutoffs
    // it also counts the pixels still blending
    if (hard) {
      if (__syncthreads_count(!done) == 0) break;
    } else {
      __syncthreads();
    }
    stage_rows<PW>(src + static_cast<size_t>(b0) * PW, nb, ox, oy, s_rows,
                   s_coef, tid, BWD_PX);

    for (int j = 0; j < nb; ++j) {
      float da = 0.0f;
      float w = 0.0f;
      const float* k = s_coef + j * 8;
      const float power = done ? 1.0f : gaussian_power(k, basis);
      if (!(power > 0.0f)) {
        const float alpha_raw = expf(power + k[6]);
        const float alpha = fminf(MAX_ALPHA, alpha_raw);
        if (!(hard && alpha < ALPHA_MIN)) {
          const float test_T = T * (1.0f - alpha);
          if (hard && test_T < T_EPS) {
            done = true;
          } else {
            w = alpha * T;
            const float* f = s_rows + j * PW + HDR;
            float phi = 0.0f;
#pragma unroll
            for (int c = 0; c < C; ++c) phi = phi + f[c] * gf[c];
            phi = phi + g_alpha;
            prefix = prefix + w * phi;
            const float S = total - prefix;
            if (alpha_raw < MAX_ALPHA) {
              da = (T * phi - S / fmaxf(1.0f - alpha, 1e-6f)) * alpha;
            }
            T = test_T;
          }
        }
      }
      float* part = s_part + (warp * BWD_BATCH + j) * VP;
      if (!__any_sync(0xffffffffu, w != 0.0f || da != 0.0f)) {
        if (lane < V) part[lane] = 0.0f;
        continue;
      }
      const float s0 = warp_sum(da);
      const float s1 = warp_sum(da * basis.x);
      const float s2 = warp_sum(da * basis.y);
      const float s3 = warp_sum(da * basis.xx);
      const float s4 = warp_sum(da * basis.yy);
      const float s5 = warp_sum(da * basis.xy);
      if (lane == 0) {
        part[0] = s0;
        part[1] = s1;
        part[2] = s2;
        part[3] = s3;
        part[4] = s4;
        part[5] = s5;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float s = warp_sum(w * gf[c]);
        if (lane == 0) part[6 + c] = s;
      }
    }
    __syncthreads();

    // thread j adds the warps' partials of Gaussian j and chains the
    // coefficient gradients to (centre, conic, opacity)
    if (tid < nb) {
      float d[V];
#pragma unroll
      for (int v = 0; v < V; ++v) d[v] = 0.0f;
      for (int wp = 0; wp < BWD_WARPS; ++wp) {
        const float* part = s_part + (wp * BWD_BATCH + tid) * VP;
#pragma unroll
        for (int v = 0; v < V; ++v) d[v] = d[v] + part[v];
      }
      const float* r = s_rows + tid * PW;
      const float mx = r[0] - ox;
      const float my = r[1] - oy;
      const float c0 = r[2], c1 = r[3], c2 = r[4], ln_op = r[5];
      float* o = dst + static_cast<size_t>(b0 + tid) * PW;
      o[0] = (-c0 * mx - c1 * my) * d[0] + c0 * d[1] + c1 * d[2];
      o[1] = (-c2 * my - c1 * mx) * d[0] + c1 * d[1] + c2 * d[2];
      o[2] = -0.5f * mx * mx * d[0] + mx * d[1] - 0.5f * d[3];
      o[3] = -mx * my * d[0] + my * d[1] + mx * d[2] - d[5];
      o[4] = -0.5f * my * my * d[0] + my * d[2] - 0.5f * d[4];
      // d_op = d_ln_op / op; the padded slots' sentinel ln_op is guarded
      o[5] = ln_op > -1e29f ? d[0] * expf(-ln_op) : 0.0f;
      o[6] = 0.0f;
      o[7] = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) o[HDR + c] = d[6 + c];
    }
    walked = b0 + nb;
  }

  for (size_t i = static_cast<size_t>(walked) * PW + tid;
       i < static_cast<size_t>(zero_to) * PW; i += BWD_PX) {
    dst[i] = 0.0f;
  }
}

}  // namespace ls4d

extern "C" const char* ls4d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
