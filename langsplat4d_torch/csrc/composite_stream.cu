// Stream compositor for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel langsplat4d/ops/tile_composite.py:_stream_kernel
// (entry composite_stream_pallas). Each tile blends its segment
// [starts[t], starts[t+1]) of the (tile, depth)-sorted row stream front to
// back and writes the [C+1, H, W] image directly, which fuses the TPU path's
// [T, C+1, px] stitch and crop.
//
// What bounded the first version on this card (one block of 1024 threads per
// 32-px tile, one thread per pixel): its shape, not the arithmetic. At 41
// registers a thread one such block fills an SM, and it holds the SM until
// the last of its 1024 pixels has stopped; on the bench frame a staged
// Gaussian is evaluated by 382 of the tile's 1024 pixels on average and only
// 26% of those evaluations blend anything, because a 32-px tile is much
// larger than most splats. The same frame at 16-px tiles took a third of the
// time.
//
// Design: one block of 256 threads per 16x16 quadrant, so a 32-px tile is
// four independent blocks and a 16-px tile is one.
// - Every block walks the whole segment of its tile, 256 candidates a pass,
//   one per thread. With hard cutoffs at 32-px tiles thread j tests
//   candidate j against the block's quadrant (`quadrant_covered`), a ballot
//   and a prefix over the warps give the covered rows their places in depth
//   order, and only their coefficients are handed to the pixel loop, each
//   with the index of its row in the staged batch. A dropped row is one that
//   every pixel of the quadrant would skip by the blend's own rule, so it
//   contributes exactly nothing; the kept rows blend in the same order with
//   the same arithmetic as before. The rows themselves are copied whole with
//   16-byte loads while the tests run; four blocks read a tile's rows, the
//   later ones from L2.
// - A quadrant whose 256 pixels have stopped leaves (__syncthreads_count);
//   a quadrant beyond the image edge leaves at once. Several blocks share
//   an SM (four at row width 16), so a long segment that only a few pixels
//   still walk no longer idles the whole SM.
// - The pixel loop reads a Gaussian's coefficients as two 16-byte broadcast
//   loads and its features as 16-byte loads, computes the powers of AHEAD
//   Gaussians before it enters the serial T chain of the first, and skips
//   the expf where power + ln_op is below ln(1/255) by a margin of ~2000
//   ulps (the exact alpha < 1/255 test on the expf result decides the rest,
//   so no pair changes sides).
// - A warp is an 8x4 patch of pixels, not a strip: whole-warp skips and
//   whole-warp stops are more frequent, and the image writes are 32-byte
//   runs.
//
// Tensor cores are no way out: the power in coefficient form is a
// [pixels, 6] x [6, Gaussians] product, but its constant term reaches ~800
// at 32-px tiles and cancels against the others, TF32 keeps 10 bits of
// mantissa, and the image is held to 3e-5.
//
// Arithmetic (composite_common.cuh) follows the TPU kernel: this is what the
// JAX package's kernel computes on the CPU, bit for bit. At 32-px tiles the
// coefficient form loses up to ~3e-4 of power to cancellation (k0 reaches
// ~800 for a 1-px splat 40 px from the tile origin), so a different rounding
// anywhere shows as ~1e-4 in the image; the form is kept for parity with the
// reference. The operations that reach the image and their order match
// composite_stream_plain in ops/composite.py; the quadrant test matches
// quadrant_cover_plain there.

#include "composite_common.cuh"

namespace {

using namespace ls4d;

constexpr int QUAD = 16;           // a block composites 16 x 16 pixels
constexpr int PX = QUAD * QUAD;
constexpr int NW = PX / 32;
constexpr int BATCH = PX;          // candidates per pass, one per thread
constexpr int AHEAD = 4;           // powers computed ahead of the T chain

// The quadrant test keeps a row whose largest power + ln_op over the
// quadrant is within this margin below ln(1/255): an absolute part and a
// part relative to the magnitude M of the terms the power is summed from
// (the coefficient form rounds each of ~12 operations to 6e-8 of M).
constexpr float COVER_MARGIN_ABS = 1e-2f;
constexpr float COVER_MARGIN_REL = 4e-6f;

// min over t in [lo, hi] of a d^2 + 2 b d (t - centre) + c (t - centre)^2
__device__ __forceinline__ float edge_min(float a, float b, float c, float d,
                                          float lo, float hi, float centre) {
  const float at = centre - b * d / c;
  const float e = fminf(fmaxf(at, lo), hi) - centre;
  return a * d * d + 2.0f * b * d * e + c * e * e;
}

// Could any pixel of the 16x16 quadrant whose first pixel is (x0, y0), in
// the tile at (ox, oy), blend the Gaussian (centre cx, cy, conic a, b, c,
// ln_op) under hard cutoffs? False only if the least value over the
// quadrant's pixel rect of the conic quadratic q (power = -q / 2) leaves
// power + ln_op below ln(1/255) by more than the margin, so that every
// pixel would find alpha < 1/255. The minimum of a positive definite
// quadratic over a rect that does not hold the centre lies on an edge; a
// conic that is not positive definite, or not a number, is kept.
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

// One pixel blends the `n` Gaussians whose coefficients stand in s_coef
// ([k0 k1 k2 k3], [k4 k5 ln_op row] per Gaussian, n rounded up to AHEAD with
// entries that never blend) front to back into (T, acc, asum); `row` is the
// Gaussian's row in s_rows. With hard cutoffs it stops for good before the
// first Gaussian that would take T below 1e-4, and says so in *done. The
// operations on T, acc and asum are `blend_staged`'s.
template <int PW>
__device__ __forceinline__ void blend_compacted(const float* s_rows,
                                                const float4* s_coef, int n,
                                                const PixelBasis& p, int hard,
                                                float* T,
                                                float (&acc)[PW - HDR],
                                                float* asum, bool* done) {
  constexpr int C = PW - HDR;
  for (int j0 = 0; j0 < n; j0 += AHEAD) {
    float s[AHEAD];
    int row[AHEAD];
    bool take[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const float4 ka = s_coef[2 * (j0 + u)];
      const float4 kb = s_coef[2 * (j0 + u) + 1];
      const float power = gaussian_power(ka, kb, p);
      s[u] = power + kb.z;
      take[u] = !(power > 0.0f) &&
                !(hard && s[u] < LN_ALPHA_MIN - PRETEST_MARGIN);
      row[u] = __float_as_int(kb.w);
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (!take[u]) continue;
      const float alpha = fminf(MAX_ALPHA, expf(s[u]));
      if (hard && alpha < ALPHA_MIN) continue;
      const float test_T = *T * (1.0f - alpha);
      if (hard && test_T < T_EPS) {
        *done = true;
        return;
      }
      const float w = alpha * *T;
      const float4* f =
          reinterpret_cast<const float4*>(s_rows + row[u] * PW + HDR);
#pragma unroll
      for (int c4 = 0; c4 < C / 4; ++c4) {
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

// `quads` is the number of quadrants along a side of a tile: 2 at 32-px
// tiles, 1 at 16-px tiles. Block 4 t + q (or t) is quadrant q of tile t.
template <int PW>
__global__ void __launch_bounds__(PX)
composite_stream_kernel(const float* __restrict__ rows,
                        const int* __restrict__ starts,
                        const float* __restrict__ bg,
                        float* __restrict__ out,
                        int tiles_x, int quads, int height, int width,
                        int hard) {
  constexpr int C = PW - HDR;
  constexpr int ROW4 = PW / 4;     // 16-byte pieces of a row
  __shared__ __align__(16) float s_rows[BATCH * PW];
  __shared__ float4 s_coef[2 * (BATCH + AHEAD)];
  __shared__ int s_cnt[NW];        // covered rows per warp

  const int tile = blockIdx.x / (quads * quads);
  const int quad = blockIdx.x % (quads * quads);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile_size = quads * QUAD;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  // the quadrant's first pixel, tile-local and in the image
  const int qx = (quad % quads) * QUAD;
  const int qy = (quad / quads) * QUAD;
  if (tx * tile_size + qx >= width || ty * tile_size + qy >= height) return;
  // a warp is 8 x 4 pixels, the block's 8 warps are 2 across and 4 down
  const int lx = qx + (warp & 1) * 8 + (lane & 7);
  const int ly = qy + (warp >> 1) * 4 + (lane >> 3);
  const int px = tx * tile_size + lx;
  const int py = ty * tile_size + ly;
  const bool inside = px < width && py < height;
  const float ox = static_cast<float>(tx * tile_size);
  const float oy = static_cast<float>(ty * tile_size);
  const PixelBasis basis(lx, ly);
  // without hard cutoffs every pixel blends every Gaussian, however faint;
  // a 16-px tile is one quadrant, and the stream holds no pair that the
  // same test at its build would have dropped
  const bool cull = hard && quads > 1;

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
    // barrier before the shared buffers are overwritten; with hard cutoffs
    // it also counts the pixels still blending
    if (hard) {
      if (__syncthreads_count(!done) == 0) break;
    } else {
      __syncthreads();
    }
    const float4* src =
        reinterpret_cast<const float4*>(rows + static_cast<size_t>(b0) * PW);
    float4* s_rows4 = reinterpret_cast<float4*>(s_rows);
    for (int i = tid; i < nb * ROW4; i += PX) s_rows4[i] = src[i];

    // thread j: candidate j's header, and whether it reaches the quadrant
    float r[HDR];
    bool covered = tid < nb;
    if (covered) {
      const float4 h0 = src[tid * ROW4];
      const float4 h1 = src[tid * ROW4 + 1];
      r[0] = h0.x, r[1] = h0.y, r[2] = h0.z, r[3] = h0.w;
      r[4] = h1.x, r[5] = h1.y;
      if (cull) {
        covered = quadrant_covered(r[0], r[1], r[2], r[3], r[4], r[5], ox, oy,
                                   ox + static_cast<float>(qx),
                                   oy + static_cast<float>(qy));
      }
    }
    int place = tid;
    int n = nb;
    if (cull) {
      const unsigned ballot = __ballot_sync(0xffffffffu, covered);
      if (lane == 0) s_cnt[warp] = __popc(ballot);
      __syncthreads();
      place = __popc(ballot & ((1u << lane) - 1u));
      n = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const int cnt = s_cnt[w];
        if (w < warp) place += cnt;
        n += cnt;
      }
    }
    if (covered) {
      float k[7];
      row_coefficients(r, ox, oy, k);
      s_coef[2 * place] = make_float4(k[0], k[1], k[2], k[3]);
      s_coef[2 * place + 1] =
          make_float4(k[4], k[5], k[6], __int_as_float(tid));
    }
    if (tid < AHEAD) {   // power = 1 > 0: never blends
      s_coef[2 * (n + tid)] = make_float4(1.0f, 0.0f, 0.0f, 0.0f);
      s_coef[2 * (n + tid) + 1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    if (!done) {
      blend_compacted<PW>(s_rows, s_coef, n, basis, hard, &T, acc, &asum,
                          &done);
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
// cudaErrorInvalidValue for a row width or tile size the kernel does not
// take. `rows` must be 16-byte aligned.
extern "C" int ls4d_composite_stream(const float* rows, const int* starts,
                                     const float* bg, float* out,
                                     int num_tiles, int tiles_x,
                                     int tile_size, int height, int width,
                                     int pw, int hard_cutoffs,
                                     cudaStream_t stream) {
  if (tile_size != 16 && tile_size != 32) return cudaErrorInvalidValue;
  if (num_tiles <= 0) return cudaSuccess;
  const int quads = tile_size / QUAD;
  const dim3 grid(num_tiles * quads * quads);
  const dim3 block(PX);
  switch (pw) {
    case 16:
      composite_stream_kernel<16><<<grid, block, 0, stream>>>(
          rows, starts, bg, out, tiles_x, quads, height, width, hard_cutoffs);
      break;
    case 24:
      composite_stream_kernel<24><<<grid, block, 0, stream>>>(
          rows, starts, bg, out, tiles_x, quads, height, width, hard_cutoffs);
      break;
    case 32:
      composite_stream_kernel<32><<<grid, block, 0, stream>>>(
          rows, starts, bg, out, tiles_x, quads, height, width, hard_cutoffs);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
