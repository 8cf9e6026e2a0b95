// Backward of the tile-list compositor for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel langsplat4d/ops/tile_composite.py:_backward_kernel
// (entry composite_backward_pallas). Each tile re-walks its list front to
// back with the forward's recurrences and writes one gradient row per
// (tile, slot): d_rows[t, k, :] = [dmx, dmy, dc0, dc1, dc2, d_op, 0, 0,
// d_feat_0 ..], zero beyond the walked slots. Every (tile, slot) owns its
// row, so there are no global atomics; the caller scatter-adds the rows to
// the Gaussians.
//
// Per pixel and Gaussian i (w_i = alpha_i T_i, T_{i+1} = T_i (1 - alpha_i)):
//   phi_i    = sum_c f_{i,c} g_c + g_alpha
//   prefix  += w_i phi_i;  S_i = total - prefix   (total = <accum, g> per pixel)
//   d_alpha  = T_i phi_i - S_i / max(1 - alpha_i, 1e-6), zero where the
//              Gaussian is skipped, the pixel has stopped, or alpha is
//              clamped at 0.99
//   da       = d_alpha * alpha_i                    (= dL/dpower = dL/dln_op)
// and per Gaussian the sums over the tile's 256 pixels of da * basis[0..5]
// (the gradient of the six power coefficients; basis[0] = 1 gives d_ln_op)
// and of w_i g_c (the feature gradient). The coefficient gradients are then
// chained to (conic, centre) by one thread per Gaussian.
//
// Design: one block per 16x16 tile, one thread per pixel, rows [T, K, PW]
// staged BATCH at a time as in the forward. The 6 + C sums per Gaussian are
// reduced inside each warp with shuffles (a warp none of whose pixels the
// Gaussian reaches skips them), the 8 warps' partials go to shared memory,
// and after the batch thread j adds them in warp order and writes row j.
// Pixels that have stopped keep taking part with zeros; the block leaves
// when all its pixels are done or counts[t] is reached, and zeroes the
// slots it did not walk. The power chain and the cutoffs are the forward's
// (composite_common.cuh), so both agree on which entries are in.
//
// What bounds it: arithmetic and shuffles. A (Gaussian, pixel) pair costs
// the forward's work plus ~6 + 2C operations and 5 (6 + C) shuffle-adds,
// against one row read and one row written per Gaussian shared by 256
// pixels. The sums' order differs from the plain version's, so the two are
// not bit-equal.

#include "composite_common.cuh"

namespace {

using namespace ls4d;

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;
constexpr int NW = PX / 32;  // warps per block
constexpr int BATCH = 32;    // rows staged per pass

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int PW>
__global__ void __launch_bounds__(PX)
composite_tiles_backward_kernel(const float* __restrict__ rows,
                                const int* __restrict__ counts,
                                const float* __restrict__ g_out,
                                const float* __restrict__ total_in,
                                float* __restrict__ d_rows,
                                int K, int tiles_x, int hard) {
  constexpr int C = PW - HDR;
  constexpr int V = 6 + C;     // sums per Gaussian
  constexpr int VP = V | 1;    // odd stride: thread j reads without conflicts
  __shared__ float s_rows[BATCH * PW];
  __shared__ float s_coef[BATCH * 8];
  __shared__ float s_part[NW * BATCH * VP];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float ox = static_cast<float>((tile % tiles_x) * TILE);
  const float oy = static_cast<float>((tile / tiles_x) * TILE);
  const PixelBasis basis(tid % TILE, tid / TILE);
  const int count = min(counts[tile], K);
  const float* tile_rows = rows + static_cast<size_t>(tile) * K * PW;
  float* tile_out = d_rows + static_cast<size_t>(tile) * K * PW;

  const float* g = g_out + static_cast<size_t>(tile) * (C + 1) * PX + tid;
  float gf[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gf[c] = g[c * PX];
  const float g_alpha = g[C * PX];
  const float total = total_in[static_cast<size_t>(tile) * PX + tid];

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
    stage_rows<PW>(tile_rows + static_cast<size_t>(b0) * PW, nb, ox, oy,
                   s_rows, s_coef, tid, PX);

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
      float* part = s_part + (warp * BATCH + j) * VP;
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
      for (int wp = 0; wp < NW; ++wp) {
        const float* part = s_part + (wp * BATCH + tid) * VP;
#pragma unroll
        for (int v = 0; v < V; ++v) d[v] = d[v] + part[v];
      }
      const float* r = s_rows + tid * PW;
      const float mx = r[0] - ox;
      const float my = r[1] - oy;
      const float c0 = r[2], c1 = r[3], c2 = r[4], ln_op = r[5];
      float* o = tile_out + static_cast<size_t>(b0 + tid) * PW;
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

  for (int i = walked * PW + tid; i < K * PW; i += PX) tile_out[i] = 0.0f;
}

}  // namespace

// rows [T, K, PW], counts [T], g_out [T, PW - 8 + 1, 256], total [T, 256]
// -> d_rows [T, K, PW]. Launches on `stream`; returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a row width the kernel does
// not take.
extern "C" int ls4d_composite_tiles_backward(
    const float* rows, const int* counts, const float* g_out,
    const float* total, float* d_rows, int num_tiles, int K, int tiles_x,
    int pw, int hard_cutoffs, cudaStream_t stream) {
  if (num_tiles <= 0) return cudaSuccess;
  const dim3 grid(num_tiles);
  const dim3 block(PX);
  switch (pw) {
    case 16:
      composite_tiles_backward_kernel<16><<<grid, block, 0, stream>>>(
          rows, counts, g_out, total, d_rows, K, tiles_x, hard_cutoffs);
      break;
    case 24:
      composite_tiles_backward_kernel<24><<<grid, block, 0, stream>>>(
          rows, counts, g_out, total, d_rows, K, tiles_x, hard_cutoffs);
      break;
    case 32:
      composite_tiles_backward_kernel<32><<<grid, block, 0, stream>>>(
          rows, counts, g_out, total, d_rows, K, tiles_x, hard_cutoffs);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
