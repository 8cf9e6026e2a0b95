// What the six Hopper compositors share: the packed-row constants, the power
// chain, the forward walk over a block's 16x16 pixels with its cover tests
// (the four forward kernels call it), and the backward's walk over one
// 16x16 tile's rows with its transposed warp reduction (the two backward
// kernels call it). The power chain (`gaussian_power`) and the alpha, cutoff
// and stop rule (`pair_may_blend`, `pair_blend`) stand here once for both.
//
// Row layout (PW floats): [pix_x, pix_y, conic0, conic1, conic2, ln_op, 0, 0,
// feat_0 .. feat_{PW-9}] -- the JAX package's kernel rows, row-major. The
// cell rows carry their tile rect in the two spare columns.
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
constexpr float LN_ALPHA_MIN = -5.5412635f;   // ln(1/255)
// With hard cutoffs the walks skip the expf of a pair whose power + ln_op is
// below ln(1/255) - PRETEST_MARGIN: e^-0.001 is 4000 ulps below 1 and expf
// is good to a few, so alpha < 1/255 there for certain; the exact test on
// the expf result decides every other pair.
constexpr float PRETEST_MARGIN = 1e-3f;

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

// The power of one Gaussian (coefficients ka = [k0 k1 k2 k3], kb = [k4 k5
// . .]) at one pixel: the chain, written here and nowhere else.
__device__ __forceinline__ float gaussian_power(const float4& ka,
                                                const float4& kb,
                                                const PixelBasis& p) {
  float power = ka.x;
  power = fmaf(ka.y, p.x, power);
  power = fmaf(ka.z, p.y, power);
  power = fmaf(ka.w, p.xx, power);
  power = fmaf(kb.x, p.yy, power);
  power = fmaf(kb.y, p.xy, power);
  return power;
}

// The blend's rule for one (Gaussian, pixel) pair, here once for the
// forward and the backward walks; s = power + ln_op. A pair is skipped where
// power > 0 and, with hard cutoffs, where alpha < 1/255. `pair_may_blend`
// decides the first and, before the expf, the pairs whose s lies below
// ln(1/255) by PRETEST_MARGIN. `pair_blend` takes the expf of the rest:
// kSkip where alpha < 1/255 with hard cutoffs; kStop where, with hard
// cutoffs, the pair would take T below 1e-4 (the pixel stops for good before
// it); else kBlend, with alpha = min(0.99, e^s) and T' = T (1 - alpha).
__device__ __forceinline__ bool pair_may_blend(float power, float s,
                                               int hard) {
  return !(power > 0.0f) && !(hard && s < LN_ALPHA_MIN - PRETEST_MARGIN);
}

enum PairStep { kSkip, kStop, kBlend };

__device__ __forceinline__ PairStep pair_blend(float s, float T, int hard,
                                               float* alpha_raw,
                                               float* alpha, float* test_T) {
  *alpha_raw = expf(s);
  *alpha = fminf(MAX_ALPHA, *alpha_raw);
  if (hard && *alpha < ALPHA_MIN) return kSkip;
  *test_T = T * (1.0f - *alpha);
  if (hard && *test_T < T_EPS) return kStop;
  return kBlend;
}

// Every compositor block is 256 threads over 16 x 16 pixels.
constexpr int QUAD = 16;
constexpr int BLOCK_PX = QUAD * QUAD;
constexpr int BLOCK_WARPS = BLOCK_PX / 32;

// The pixel of the 16x16 block that thread `tid` owns (y * 16 + x): a warp
// is an 8x4 patch (the block's 8 warps 2 across and 4 down), so that a
// Gaussian reaches fewer warps, a warp's pixels stop together more often and
// an output row is written in 32-byte runs, than with a warp as a 16x2 strip.
__device__ __forceinline__ int block_pixel(int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  return ((warp >> 1) * 4 + (lane >> 3)) * QUAD + (warp & 1) * 8 +
         (lane & 7);
}

// ---- the forward walk ----

constexpr int FWD_PASS = BLOCK_PX;  // candidates per scan pass, one a thread
constexpr int AHEAD = 4;            // powers computed ahead of the T chain

// The cover test keeps a row whose largest power + ln_op over the rect is
// within this margin below ln(1/255): an absolute part and a part relative
// to the magnitude M of the terms the power is summed from (the coefficient
// form rounds each of ~12 operations to 6e-8 of M).
constexpr float COVER_MARGIN_ABS = 1e-2f;
constexpr float COVER_MARGIN_REL = 4e-6f;

// min over t in [lo, hi] of a d^2 + 2 b d (t - centre) + c (t - centre)^2
__device__ __forceinline__ float edge_min(float a, float b, float c, float d,
                                          float lo, float hi, float centre) {
  const float at = centre - b * d / c;
  const float e = fminf(fmaxf(at, lo), hi) - centre;
  return a * d * d + 2.0f * b * d * e + c * e * e;
}

// Could any pixel of the 16x16 rect whose first pixel is (x0, y0), in the
// tile at (ox, oy), blend the Gaussian (centre cx, cy, conic a, b, c, ln_op)
// under hard cutoffs? False only if the least value over the rect of the
// conic quadratic q (power = -q / 2) leaves power + ln_op below ln(1/255) by
// more than the margin, so that every pixel would find alpha < 1/255. The
// minimum of a positive definite quadratic over a rect that does not hold
// the centre lies on an edge; a conic that is not positive definite, or not
// a number, is kept. The rect is a quadrant of a 32-px tile or a whole
// 16-px tile; the margin's magnitude is reckoned over a 32-px span either
// way.
__device__ __forceinline__ bool quadrant_covered(float cx, float cy, float a,
                                                 float b, float c,
                                                 float ln_op, float ox,
                                                 float oy, float x0,
                                                 float y0) {
  if (!(a > 0.0f && c > 0.0f && a * c > b * b)) return true;
  const float span = static_cast<float>(2 * QUAD);
  const float dx = fabsf(cx - ox) + span;
  const float dy = fabsf(cy - oy) + span;
  const float m = 0.5f * (a * dx * dx + c * dy * dy) + fabsf(b) * dx * dy;
  const float margin = COVER_MARGIN_ABS + COVER_MARGIN_REL * m;
  const float limit = 2.0f * (ln_op - LN_ALPHA_MIN + margin);
  const float x1 = x0 + static_cast<float>(QUAD - 1);
  const float y1 = y0 + static_cast<float>(QUAD - 1);
  float q = 0.0f;
  if (!(cx >= x0 && cx <= x1 && cy >= y0 && cy <= y1)) {
    q = fminf(fminf(edge_min(a, b, c, x0 - cx, y0, y1, cy),
                    edge_min(a, b, c, x1 - cx, y0, y1, cy)),
              fminf(edge_min(c, b, a, y0 - cy, x0, x1, cx),
                    edge_min(c, b, a, y1 - cy, x0, x1, cx)));
  }
  return !(q > limit);
}

// The cover tests a forward kernel hands the walk: `active()` (uniform over
// the block) says whether rows are tested and compacted at all, and the
// call says whether the candidate with header columns h0 = 0..3, h1 = 4..7
// may reach the block's pixels.
struct NoCover {   // every row is blended
  __device__ bool active() const { return false; }
  __device__ bool operator()(const float4&, const float4&) const {
    return true;
  }
};

struct RectCover {   // `quadrant_covered` against the rect at (x0, y0)
  float ox, oy, x0, y0;
  bool on;
  __device__ bool active() const { return on; }
  __device__ bool operator()(const float4& h0, const float4& h1) const {
    return quadrant_covered(h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, ox, oy, x0,
                            y0);
  }
};

// One pixel blends the `n` Gaussians whose coefficients stand in s_coef
// ([k0 k1 k2 k3], [k4 k5 ln_op .] per Gaussian, n rounded up to AHEAD with
// entries that never blend) and whose features stand in s_feat (C / 4
// float4 each) front to back into (T, acc, asum) by the pair rule; a pixel
// that stops says so in *done. The powers of AHEAD Gaussians, and the
// pre-test, are computed before the serial T chain of the first.
template <int PW>
__device__ __forceinline__ void blend_batch(const float4* s_coef,
                                            const float4* s_feat, int n,
                                            const PixelBasis& p, int hard,
                                            float* T, float (&acc)[PW - HDR],
                                            float* asum, bool* done) {
  constexpr int C4 = (PW - HDR) / 4;
  for (int j0 = 0; j0 < n; j0 += AHEAD) {
    float s[AHEAD];
    bool take[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const float4 ka = s_coef[2 * (j0 + u)];
      const float4 kb = s_coef[2 * (j0 + u) + 1];
      const float power = gaussian_power(ka, kb, p);
      s[u] = power + kb.z;
      take[u] = pair_may_blend(power, s[u], hard);
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (!take[u]) continue;
      float alpha_raw, alpha, test_T;
      const PairStep step =
          pair_blend(s[u], *T, hard, &alpha_raw, &alpha, &test_T);
      if (step == kSkip) continue;
      if (step == kStop) {
        *done = true;
        return;
      }
      const float w = alpha * *T;
      const float4* f = s_feat + (j0 + u) * C4;
#pragma unroll
      for (int c4 = 0; c4 < C4; ++c4) {
        const float4 v = f[c4];
        acc[4 * c4 + 0] = acc[4 * c4 + 0] + v.x * w;
        acc[4 * c4 + 1] = acc[4 * c4 + 1] + v.y * w;
        acc[4 * c4 + 2] = acc[4 * c4 + 2] + v.z * w;
        acc[4 * c4 + 3] = acc[4 * c4 + 3] + v.w * w;
      }
      *asum = *asum + w;
      *T = test_T;
    }
  }
}

// The pixel of the calling thread (`block_pixel`), from %tid.x read anew:
// a kernel stores its output by it after the walk, so that nothing of the
// pixel's address has to stay in a register across the walk.
__device__ __forceinline__ int pixel_after_walk() {
  int tid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  return block_pixel(tid);
}

// One block of 256 threads walks the `count` front-to-back candidate rows
// at `src` (16-byte aligned) for its 16x16 pixels, the tile's origin being
// (ox, oy), and blends them into each pixel's (T, acc, asum, done), the
// thread's pixel having the tile-local basis `basis`; the caller stores the
// result.
//
// A scan pass takes 256 candidates, one a thread. Thread j loads candidate
// j's header as two 16-byte loads and, where the cover test is active, tests
// it; a ballot and a prefix over the warps give the kept rows their places in
// depth order after those already buffered. The thread that loaded a kept row
// turns its header into two float4 coefficients in the same pass and gathers
// its features into the row's place with 16-byte loads; with EARLY_GATHER it
// loads them right after its test, so that their latency overlaps the
// ballot's barrier, at the cost of holding them in registers (C / 4 float4).
// Without a cover test every row is kept and the features are copied with
// coalesced 16-byte loads instead. The buffer holds DEPTH rows: it is blended
// when another pass might not fit (with DEPTH = 256, after every pass) or the
// list ends, so a walk whose tests keep few rows a pass blends full batches.
// Every pass starts with a barrier that, with hard cutoffs, counts the pixels
// still blending, and the block leaves once none is.
template <int PW, int DEPTH, bool EARLY_GATHER, class Cover>
__device__ __forceinline__ void forward_walk(const float* __restrict__ src,
                                             int count, float ox, float oy,
                                             const PixelBasis& basis,
                                             const Cover& cover, int hard,
                                             float* T,
                                             float (&acc)[PW - HDR],
                                             float* asum, bool* done) {
  constexpr int C4 = (PW - HDR) / 4;   // 16-byte pieces of a feature block
  constexpr int ROW4 = PW / 4;         // 16-byte pieces of a row
  static_assert(DEPTH >= FWD_PASS && DEPTH % AHEAD == 0, "buffer depth");
  __shared__ float4 s_coef[2 * (DEPTH + AHEAD)];
  __shared__ float4 s_feat[DEPTH * C4];
  __shared__ int s_cnt[BLOCK_WARPS];   // kept rows per warp

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool compact = cover.active();
  int n_buf = 0;                       // rows buffered, not yet blended

  for (int b0 = 0; b0 < count; b0 += FWD_PASS) {
    const int nb = min(FWD_PASS, count - b0);
    // barrier before the buffer is written again; with hard cutoffs it
    // also counts the pixels still blending
    if (hard) {
      if (__syncthreads_count(!*done) == 0) return;
    } else {
      __syncthreads();
    }
    const float4* src4 =
        reinterpret_cast<const float4*>(src + static_cast<size_t>(b0) * PW);
    bool keep = tid < nb;
    float4 h0, h1;
    float4 f[C4];
    if (keep) {
      h0 = src4[tid * ROW4];
      h1 = src4[tid * ROW4 + 1];
      if (compact) {
        keep = cover(h0, h1);
        if (EARLY_GATHER && keep) {
#pragma unroll
          for (int c4 = 0; c4 < C4; ++c4) f[c4] = src4[tid * ROW4 + 2 + c4];
        }
      }
    }
    int place = n_buf + tid;
    int n_new = nb;
    if (compact) {
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_cnt[warp] = __popc(ballot);
      __syncthreads();
      place = n_buf + __popc(ballot & ((1u << lane) - 1u));
      n_new = 0;
#pragma unroll
      for (int w = 0; w < BLOCK_WARPS; ++w) {
        const int cnt = s_cnt[w];
        if (w < warp) place += cnt;
        n_new += cnt;
      }
    }
    if (keep) {
      const float r[6] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y};
      float k[7];
      row_coefficients(r, ox, oy, k);
      s_coef[2 * place] = make_float4(k[0], k[1], k[2], k[3]);
      s_coef[2 * place + 1] = make_float4(k[4], k[5], k[6], 0.0f);
      if (compact) {
#pragma unroll
        for (int c4 = 0; c4 < C4; ++c4) {
          s_feat[place * C4 + c4] =
              EARLY_GATHER ? f[c4] : src4[tid * ROW4 + 2 + c4];
        }
      }
    }
    if (!compact) {
      float4* dst = s_feat + n_buf * C4;
      for (int i = tid; i < nb * C4; i += BLOCK_PX) {
        const int j = i / C4;
        dst[i] = src4[j * ROW4 + 2 + (i - j * C4)];
      }
    }
    n_buf += n_new;
    if (DEPTH == FWD_PASS || n_buf + FWD_PASS > DEPTH ||
        b0 + FWD_PASS >= count) {
      if (tid < AHEAD) {   // power = 1 > 0: never blends
        s_coef[2 * (n_buf + tid)] = make_float4(1.0f, 0.0f, 0.0f, 0.0f);
        s_coef[2 * (n_buf + tid) + 1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      __syncthreads();
      if (!*done) {
        blend_batch<PW>(s_coef, s_feat, n_buf, basis, hard, T, acc, asum,
                        done);
      }
      n_buf = 0;
    }
  }
}

// ---- the backward's walk, shared by the tile-list and the stream layout ----

// One step of the transposed reduction: a lane keeps the half of its 2 HALF
// terms that its bit HALF of the lane number names, hands the other half to
// the lane at distance HALF and adds what that lane hands over; then the
// same on the kept half. The halves are chosen with selects on registers,
// never by a dynamic index.
template <int HALF>
__device__ __forceinline__ void exchange_halves(float* v, int lane) {
  const bool upper = (lane & HALF) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float keep = upper ? v[HALF + i] : v[i];
    const float send = upper ? v[i] : v[HALF + i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
  if constexpr (HALF > 1) exchange_halves<HALF / 2>(v, lane);
}

// Sums N (16 or 32) terms per lane over the 32 lanes of a warp, all
// together: lane l returns the sum over the lanes of term l (l mod 16 for
// N = 16). N - 1 shuffles at N = 32 and N at 16 (the last one adds the two
// half-warps), where one butterfly per term would take 5 N; the order of
// every sum is fixed. `v` is used up.
template <int N>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[N], int lane) {
  static_assert(N == 16 || N == 32, "16 or 32 terms a lane");
  exchange_halves<N / 2>(v, lane);
  if constexpr (N == 16) v[0] = v[0] + __shfl_xor_sync(0xffffffffu, v[0], 16);
  return v[0];
}

// One pixel's step of the backward walk over one staged Gaussian
// (coefficients k, features f): advances the pixel's T, prefix and done as
// the forward does and gives da = dL/dpower and w = alpha T of this pair,
// both zero where the Gaussian is skipped or the pixel has stopped.
template <int PW>
__device__ __forceinline__ void pixel_gradient(
    const float* k, const float* f, const PixelBasis& basis,
    const float (&gf)[PW - HDR], float g_alpha, float total, int hard,
    float* T, float* prefix, bool* done, float* da, float* w) {
  constexpr int C = PW - HDR;
  *da = 0.0f;
  *w = 0.0f;
  const float4 ka = reinterpret_cast<const float4*>(k)[0];
  const float4 kb = reinterpret_cast<const float4*>(k)[1];
  float power = gaussian_power(ka, kb, basis);
  if (*done) power = 1.0f;
  const float s = power + kb.z;
  if (!pair_may_blend(power, s, hard)) return;
  float alpha_raw, alpha, test_T;
  const PairStep step = pair_blend(s, *T, hard, &alpha_raw, &alpha, &test_T);
  if (step == kSkip) return;
  if (step == kStop) {
    *done = true;
    return;
  }
  *w = alpha * *T;
  float phi = 0.0f;
#pragma unroll
  for (int c4 = 0; c4 < C / 4; ++c4) {
    const float4 v = reinterpret_cast<const float4*>(f)[c4];
    phi = phi + v.x * gf[4 * c4 + 0];
    phi = phi + v.y * gf[4 * c4 + 1];
    phi = phi + v.z * gf[4 * c4 + 2];
    phi = phi + v.w * gf[4 * c4 + 3];
  }
  phi = phi + g_alpha;
  *prefix = *prefix + *w * phi;
  const float S = total - *prefix;
  if (alpha_raw < MAX_ALPHA) {
    // S times the approximate reciprocal (2 ulps, no slow path), where the
    // plain version divides
    *da = (*T * phi - __fdividef(S, fmaxf(1.0f - alpha, 1e-6f))) * alpha;
  }
  *T = test_T;
}

// The N terms (6 + C of them, then zeros) whose sums over the tile's pixels
// make a Gaussian's gradient row: da times the pixel basis, w times the
// feature cotangents.
template <int C, int N>
__device__ __forceinline__ void gradient_terms(float da, float w,
                                               const PixelBasis& basis,
                                               const float (&gf)[C],
                                               float (&v)[N]) {
  v[0] = da;
  v[1] = da * basis.x;
  v[2] = da * basis.y;
  v[3] = da * basis.xx;
  v[4] = da * basis.yy;
  v[5] = da * basis.xy;
#pragma unroll
  for (int c = 0; c < C; ++c) v[6 + c] = w * gf[c];
#pragma unroll
  for (int i = 6 + C; i < N; ++i) v[i] = 0.0f;
}

// One block of 256 threads re-walks the `count` front-to-back rows at `src`
// for the 16x16 tile at (ox, oy) with the forward's recurrences and writes
// one gradient row per row to `dst`: [dmx, dmy, dc0, dc1, dc2, d_op, 0, 0,
// d_feat_0 ..]; rows [walked, zero_to) of `dst`, which the block did not
// reach, are zeroed. `g` points at this pixel's entry of the tile's
// cotangent [C + 1, 256]; `total` is <accum, g> of this pixel. `src` and
// `dst` are 16-byte aligned.
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
// and of w_i g_c (the feature gradient).
//
// A thread owns a pixel of an 8x4 patch per warp (`block_pixel`). Rows
// are staged 64 or 32 at a time: whole rows with 16-byte loads while thread
// j turns row j's header, read from global memory, into its coefficients
// (one barrier). The V = 6 + C sums of a Gaussian are reduced across a warp
// together (`warp_transpose_sum`), after which lane v holds sum v and the
// warp's partials go to shared memory with one store; a warp none of whose
// pixels the Gaussian reaches notes that in a bit mask instead, and a warp
// all of whose pixels have stopped skips the batch's Gaussians altogether.
// After the batch all 256 threads add the warps' partials in warp order,
// each thread one sum of one Gaussian, and then each thread chains 16 bytes
// of a gradient row to (centre, conic, opacity) and stores them, so the rows
// leave as whole coalesced lines. The order of every sum is fixed: the
// kernel is deterministic. The block leaves when all its pixels are done or
// `count` is reached.
template <int PW>
__device__ __forceinline__ void backward_walk(const float* __restrict__ src,
                                              int count, int zero_to,
                                              float ox, float oy,
                                              const float* __restrict__ g,
                                              float total,
                                              float* __restrict__ dst,
                                              int hard) {
  constexpr int C = PW - HDR;
  constexpr int V = 6 + C;               // sums per Gaussian
  constexpr int N = V <= 16 ? 16 : 32;   // terms a lane, padded with zeros
  constexpr int ROW4 = PW / 4;           // 16-byte pieces of a row
  // rows staged per pass: 64 where the warps' partials of a batch leave
  // room in 48 KB of static shared memory (row width 16), else 32
  constexpr int BATCH = V <= 16 ? 64 : 32;
  using Mask = unsigned long long;       // a bit per row of a batch
  __shared__ __align__(16) float s_rows[BATCH * PW];
  __shared__ __align__(16) float s_coef[BATCH * 8];
  __shared__ float s_part[BLOCK_WARPS * BATCH * V];
  __shared__ float s_sum[BATCH * V];
  __shared__ Mask s_mask[BLOCK_WARPS];   // bit j: the warp has partials of j

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pixel = block_pixel(tid);
  const PixelBasis basis(pixel % QUAD, pixel / QUAD);

  float gf[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gf[c] = g[c * BLOCK_PX];
  const float g_alpha = g[C * BLOCK_PX];

  float T = 1.0f;
  float prefix = 0.0f;
  bool done = false;
  int walked = 0;

  for (int b0 = 0; b0 < count; b0 += BATCH) {
    const int nb = min(BATCH, count - b0);
    // barrier before the shared buffers are overwritten; with hard cutoffs
    // it also counts the pixels still blending
    if (hard) {
      if (__syncthreads_count(!done) == 0) break;
    } else {
      __syncthreads();
    }
    // whole rows with 16-byte loads; meanwhile thread j turns row j's
    // header, read from global memory, into its coefficients
    const float4* src4 = reinterpret_cast<const float4*>(
        src + static_cast<size_t>(b0) * PW);
    for (int i = tid; i < nb * ROW4; i += BLOCK_PX) {
      reinterpret_cast<float4*>(s_rows)[i] = src4[i];
    }
    if (tid < nb) {
      const float4 h0 = src4[tid * ROW4];
      const float4 h1 = src4[tid * ROW4 + 1];
      const float r[6] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y};
      row_coefficients(r, ox, oy, s_coef + tid * 8);
    }
    __syncthreads();

    Mask touched = 0;
    if (__any_sync(0xffffffffu, !done)) {
      for (int j = 0; j < nb; ++j) {
        float da, w;
        pixel_gradient<PW>(s_coef + j * 8, s_rows + j * PW + HDR, basis, gf,
                           g_alpha, total, hard, &T, &prefix, &done, &da, &w);
        if (!__any_sync(0xffffffffu, w != 0.0f || da != 0.0f)) continue;
        touched |= Mask(1) << j;
        float v[N];
        gradient_terms<C, N>(da, w, basis, gf, v);
        const float sum = warp_transpose_sum<N>(v, lane);
        if (lane < V) s_part[(warp * BATCH + j) * V + lane] = sum;
      }
    }
    if (lane == 0) s_mask[warp] = touched;
    __syncthreads();

    // every thread: one sum of one Gaussian over the warps that have it
    for (int e = tid; e < nb * V; e += BLOCK_PX) {
      const int j = e / V;
      float d = 0.0f;
#pragma unroll
      for (int wp = 0; wp < BLOCK_WARPS; ++wp) {
        if ((s_mask[wp] >> j) & 1) d = d + s_part[wp * BATCH * V + e];
      }
      s_sum[e] = d;
    }
    __syncthreads();
    // every thread: 16 bytes of a gradient row, chained to (centre, conic,
    // opacity)
    for (int t = tid; t < nb * ROW4; t += BLOCK_PX) {
      const int j = t / ROW4;
      const int piece = t % ROW4;
      const float* d = s_sum + j * V;
      float4 o;
      if (piece < 2) {
        const float* r = s_rows + j * PW;
        const float mx = r[0] - ox;
        const float my = r[1] - oy;
        const float c0 = r[2], c1 = r[3], c2 = r[4], ln_op = r[5];
        if (piece == 0) {
          o.x = (-c0 * mx - c1 * my) * d[0] + c0 * d[1] + c1 * d[2];
          o.y = (-c2 * my - c1 * mx) * d[0] + c1 * d[1] + c2 * d[2];
          o.z = -0.5f * mx * mx * d[0] + mx * d[1] - 0.5f * d[3];
          o.w = -mx * my * d[0] + my * d[1] + mx * d[2] - d[5];
        } else {
          o.x = -0.5f * my * my * d[0] + my * d[2] - 0.5f * d[4];
          // d_op = d_ln_op / op; the padded slots' sentinel ln_op is guarded
          o.y = ln_op > -1e29f ? d[0] * expf(-ln_op) : 0.0f;
          o.z = 0.0f;
          o.w = 0.0f;
        }
      } else {
        const float* df = d + 6 + 4 * (piece - 2);
        o = make_float4(df[0], df[1], df[2], df[3]);
      }
      reinterpret_cast<float4*>(dst + static_cast<size_t>(b0) * PW)[t] = o;
    }
    walked = b0 + nb;
  }

  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (size_t i = static_cast<size_t>(walked) * ROW4 + tid;
       i < static_cast<size_t>(zero_to) * ROW4; i += BLOCK_PX) {
    dst4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

}  // namespace ls4d

extern "C" const char* ls4d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
