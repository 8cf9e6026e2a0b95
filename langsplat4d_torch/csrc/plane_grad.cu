// The backward of the HexPlane's bilinear plane sample (grid_sample_2d,
// align_corners, border padding) for NVIDIA Hopper (sm_90a), without float
// atomics: two identical calls give the same bits.
//
// aten's CUDA backward (grid_sampler_2d_backward) adds each point's four
// corner contributions into the plane gradient with atomicAdd, so the order
// of the additions, and the rounding, change from run to run, and Adam turns
// that rounding into steps of up to a learning rate. The JAX package's
// grid_sample_2d (corner gathers and a lerp, langsplat4d/ops/grid_sample.py)
// has no such kernel: XLA's scatter-add is deterministic there.
//
// The work, in four launches on the caller's stream:
// 1. `corners`, a thread per point: aten's source index and clip (the
//    border counts as out of bounds for the coordinates' gradient), the
//    coordinates' gradient summed over the channels in order, as aten sums
//    it, and the four corners' cell keys and weights. A point whose whole
//    output gradient is 0 gets keys past the plane (HW + point), one each:
//    the padded rows of a GaussianState sit at one position and would
//    otherwise make one run of up to a million entries in one cell.
// 2. (the caller) one stable sort of the keys.
// 3. `chunk_sums`, a block per 256 sorted entries: each entry's value
//    (weight x output gradient, all channels) into shared memory, then a
//    segmented inclusive scan over the block (Hillis-Steele, fixed order).
//    A cell whose run lies inside the block is written by the run's last
//    thread; a run that crosses the block's first or last entry leaves its
//    partial sum in `partials` (head, tail).
// 4. `merge_runs`, a thread per block boundary that a run crosses first:
//    the run's tail partial, then the head partials of the blocks it
//    reaches, in block order.
// Every cell is written by exactly one thread and every sum has one order.
// Cells no entry reaches are the caller's zeros.
//
// The DenseGrid's trilinear sample (grid_sample 3-D, align_corners, zeros
// outside) takes the same path with `dense_corners` as step 1: eight
// corners a point, a corner off the grid keyed past it as well.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 256;
constexpr int MAX_C = 32;          // the widest CB

// aten's grid_sampler_compute_source_index_set_grad for align_corners and
// border padding: the source position and the derivative of the clip.
__device__ __forceinline__ float source_index(float coord, int size,
                                              float* clip_grad) {
  const float x = ((coord + 1.f) / 2.f) * (float)(size - 1);
  if (x <= 0.f) {
    *clip_grad = 0.f;
    return 0.f;
  }
  const float hi = (float)(size - 1);
  if (x >= hi) {
    *clip_grad = 0.f;
    return hi;
  }
  *clip_grad = 1.f;
  return x;
}

__global__ void corners(const float* __restrict__ coords,
                        const float* __restrict__ plane,
                        const float* __restrict__ g,
                        float* __restrict__ g_coords, int* __restrict__ keys,
                        float* __restrict__ wts, int n, int C, int H, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float mx, my;
  const float ix = source_index(coords[2 * i], W, &mx);
  const float iy = source_index(coords[2 * i + 1], H, &my);
  const float x0 = floorf(ix), y0 = floorf(iy);
  const int xi0 = (int)x0, yi0 = (int)y0;
  const bool in_x = xi0 + 1 < W, in_y = yi0 + 1 < H;
  const int xi1 = in_x ? xi0 + 1 : xi0, yi1 = in_y ? yi0 + 1 : yi0;
  const float e = x0 + 1.f - ix, w = ix - x0;      // as aten: ix_se - ix
  const float s = y0 + 1.f - iy, nn = iy - y0;
  const int hw = H * W;
  float gix = 0.f, giy = 0.f;
  bool live = false;
  for (int c = 0; c < C; ++c) {
    const float go = g[(int64_t)i * C + c];
    live |= go != 0.f;
    const float* p = plane + (int64_t)c * hw;
    // aten reads a corner beyond the plane as absent
    const float v00 = p[yi0 * W + xi0];
    const float v01 = in_x ? p[yi0 * W + xi1] : 0.f;
    const float v10 = in_y ? p[yi1 * W + xi0] : 0.f;
    const float v11 = (in_x && in_y) ? p[yi1 * W + xi1] : 0.f;
    gix -= v00 * s * go;
    giy -= v00 * e * go;
    gix += v01 * s * go;
    giy -= v01 * w * go;
    gix -= v10 * nn * go;
    giy += v10 * e * go;
    gix += v11 * nn * go;
    giy += v11 * w * go;
  }
  g_coords[2 * i] = gix * ((float)(W - 1) / 2.f) * mx;
  g_coords[2 * i + 1] = giy * ((float)(H - 1) / 2.f) * my;
  // corner j of point i is entry j * n + i: nw, ne, sw, se; a far corner
  // beyond the plane has weight exactly 0 and is clamped onto the border
  const int cell[4] = {yi0 * W + xi0, yi0 * W + xi1, yi1 * W + xi0,
                       yi1 * W + xi1};
  const float wt[4] = {e * s, w * s, e * nn, w * nn};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    keys[(int64_t)j * n + i] = live ? cell[j] : hw + i;
    wts[(int64_t)j * n + i] = wt[j];
  }
}

// The trilinear sample's step 1, a thread per point, for a grid [C, D, H, W]
// and ind [n, 3] = (x, y, z) indexing W, H and D: aten's unnormalize (no
// clip: zeros outside), the points' gradient summed over the channels and
// the eight corners in aten's order (grid_sampler_3d_backward_kernel), and
// the corners' keys and weights, corner j (tnw, tne, tsw, tse, bnw, bne,
// bsw, bse: x fastest) of point i at entry j * n + i. A corner off the grid
// reads 0, and it and every corner of a point whose output gradient is all
// 0 are keyed past the grid (DHW + point).
__global__ void dense_corners(const float* __restrict__ ind,
                              const float* __restrict__ grid,
                              const float* __restrict__ g,
                              float* __restrict__ g_ind,
                              int* __restrict__ keys,
                              float* __restrict__ wts, int n, int C, int D,
                              int H, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ix = ((ind[3 * i] + 1.f) / 2.f) * (float)(W - 1);
  const float iy = ((ind[3 * i + 1] + 1.f) / 2.f) * (float)(H - 1);
  const float iz = ((ind[3 * i + 2] + 1.f) / 2.f) * (float)(D - 1);
  const float x0 = floorf(ix), y0 = floorf(iy), z0 = floorf(iz);
  // the near and the far corner's weight along each axis
  const float nx = x0 + 1.f - ix, fx = ix - x0;
  const float ny = y0 + 1.f - iy, fy = iy - y0;
  const float nz = z0 + 1.f - iz, fz = iz - z0;
  const int xi = (int)x0, yi = (int)y0, zi = (int)z0;
  const int64_t hw = (int64_t)H * W, dhw = (int64_t)D * hw;
  int cell[8];
  bool on[8];
  float wt[8], dx[8], dy[8], dz[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ox = j & 1, oy = (j >> 1) & 1, oz = j >> 2;
    const int x = xi + ox, y = yi + oy, z = zi + oz;
    on[j] = x >= 0 && x < W && y >= 0 && y < H && z >= 0 && z < D;
    const int cx = min(max(x, 0), W - 1), cy = min(max(y, 0), H - 1);
    const int cz = min(max(z, 0), D - 1);
    cell[j] = (int)((cz * (int64_t)H + cy) * W + cx);
    const float wx = ox ? fx : nx, wy = oy ? fy : ny, wz = oz ? fz : nz;
    wt[j] = wx * wy * wz;
    dx[j] = (ox ? 1.f : -1.f) * wy * wz;
    dy[j] = (oy ? 1.f : -1.f) * wx * wz;
    dz[j] = (oz ? 1.f : -1.f) * wx * wy;
  }
  float gix = 0.f, giy = 0.f, giz = 0.f;
  bool live = false;
  for (int c = 0; c < C; ++c) {
    const float go = g[(int64_t)i * C + c];
    live |= go != 0.f;
    const float* p = grid + (int64_t)c * dhw;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!on[j]) continue;
      const float v = p[cell[j]];
      gix += v * dx[j] * go;
      giy += v * dy[j] * go;
      giz += v * dz[j] * go;
    }
  }
  g_ind[3 * i] = gix * ((float)(W - 1) / 2.f);
  g_ind[3 * i + 1] = giy * ((float)(H - 1) / 2.f);
  g_ind[3 * i + 2] = giz * ((float)(D - 1) / 2.f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    keys[(int64_t)j * n + i] = (live && on[j]) ? cell[j] : (int)(dhw + i);
    wts[(int64_t)j * n + i] = wt[j];
  }
}

// The per-channel loops run to CB, a compile-time bound on C (8, 16 or 32),
// fully unrolled and guarded by c < C, so that `add` and `acc` stay in
// registers: indexed by a loop counter known only at run time, they would
// live in local memory.
template <int CB>
__global__ void __launch_bounds__(CHUNK)
chunk_sums(const int* __restrict__ skeys, const int64_t* __restrict__ order,
           const float* __restrict__ wts, const float* __restrict__ g,
           float* __restrict__ out, float* __restrict__ partials,
           int64_t E, int n, int C, int hw) {
  // channel-major [C][CHUNK], so a warp's 32 lanes read 32 banks; then keys
  extern __shared__ float sh[];
  int* skey = reinterpret_cast<int*>(sh + CHUNK * C);
  const int t = threadIdx.x;
  const int64_t pos = (int64_t)blockIdx.x * CHUNK + t;
  const bool valid = pos < E;
  const int key = valid ? skeys[pos] : 0x7fffffff;
  skey[t] = key;
  float v[CB];
  if (valid) {
    const int64_t entry = order[pos];
    const float wt = wts[entry];
    const float* row = g + (entry % n) * C;
#pragma unroll
    for (int c = 0; c < CB; ++c)
      if (c < C) v[c] = wt * row[c];
  } else {
#pragma unroll
    for (int c = 0; c < CB; ++c) v[c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < CB; ++c)
    if (c < C) sh[c * CHUNK + t] = v[c];
  __syncthreads();
  for (int d = 1; d < CHUNK; d <<= 1) {
    const bool take = t >= d && skey[t - d] == key;
    float add[CB];
    if (take) {
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c < C) add[c] = sh[c * CHUNK + t - d];
    }
    __syncthreads();
    if (take) {
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c < C) {
          v[c] += add[c];
          sh[c * CHUNK + t] = v[c];
        }
    }
    __syncthreads();
  }
  if (!valid || key >= hw) return;              // past the plane: no cell
  const bool run_end = t == CHUNK - 1 || pos + 1 >= E || skey[t + 1] != key;
  if (!run_end) return;
  const int64_t first = (int64_t)blockIdx.x * CHUNK;
  const bool from_before = skey[0] == key && first > 0 &&
                           skeys[first - 1] == key;
  const bool goes_on = t == CHUNK - 1 && pos + 1 < E && skeys[pos + 1] == key;
  if (!from_before && !goes_on) {
#pragma unroll
    for (int c = 0; c < CB; ++c)
      if (c < C) out[(int64_t)key * C + c] = v[c];
    return;
  }
  float* part = partials + (int64_t)blockIdx.x * 2 * C;
  if (from_before) {
#pragma unroll
    for (int c = 0; c < CB; ++c)
      if (c < C) part[c] = v[c];
  }
  if (goes_on) {
#pragma unroll
    for (int c = 0; c < CB; ++c)
      if (c < C) part[C + c] = v[c];
  }
}

template <int CB>
__global__ void merge_runs(const int* __restrict__ skeys,
                           const float* __restrict__ partials,
                           float* __restrict__ out, int64_t E, int chunks,
                           int C, int hw) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x + 1;
  if (b >= chunks) return;
  const int64_t first = (int64_t)b * CHUNK;
  const int key = skeys[first];
  if (key >= hw || skeys[first - 1] != key) return;   // no run crosses b
  if (b >= 2 && skeys[first - CHUNK - 1] == key) return;  // not its first
  float acc[CB];
  const float* tail = partials + ((int64_t)(b - 1) * 2 + 1) * C;
#pragma unroll
  for (int c = 0; c < CB; ++c) acc[c] = c < C ? tail[c] : 0.f;
  for (int j = b;; ++j) {
    const float* head = partials + (int64_t)j * 2 * C;
#pragma unroll
    for (int c = 0; c < CB; ++c)
      if (c < C) acc[c] += head[c];
    const int64_t next = (int64_t)(j + 1) * CHUNK;
    if (j + 1 >= chunks || next >= E || skeys[next] != key) break;
  }
#pragma unroll
  for (int c = 0; c < CB; ++c)
    if (c < C) out[(int64_t)key * C + c] = acc[c];
}

template <int CB>
int sums(const int* skeys, const int64_t* order, const float* wts,
         const float* g, float* out, float* partials, int64_t E, int n, int C,
         int hw, cudaStream_t stream) {
  const int chunks = (int)((E + CHUNK - 1) / CHUNK);
  const size_t shmem = (size_t)CHUNK * C * sizeof(float) + CHUNK * sizeof(int);
  chunk_sums<CB><<<chunks, CHUNK, shmem, stream>>>(skeys, order, wts, g, out,
                                                   partials, E, n, C, hw);
  const int err = (int)cudaGetLastError();
  if (err != 0 || chunks < 2) return err;
  merge_runs<CB><<<(chunks - 1 + 255) / 256, 256, 0, stream>>>(
      skeys, partials, out, E, chunks, C, hw);
  return (int)cudaGetLastError();
}

}  // namespace

// Step 1: g_coords [n, 2], keys [4n] and wts [4n] from coords [n, 2], the
// plane [C, H, W] and the output gradient g [n, C].
extern "C" int ls4d_plane_grad_corners(const float* coords, const float* plane,
                                       const float* g, float* g_coords,
                                       int* keys, float* wts, int n, int C,
                                       int H, int W, cudaStream_t stream) {
  if (C < 1 || C > MAX_C) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  corners<<<(n + 255) / 256, 256, 0, stream>>>(coords, plane, g, g_coords,
                                               keys, wts, n, C, H, W);
  return (int)cudaGetLastError();
}

// The trilinear sample's step 1: g_ind [n, 3], keys [8n] and wts [8n] from
// ind [n, 3], the grid [C, D, H, W] and the output gradient g [n, C];
// D H W + n must fit an int.
extern "C" int ls4d_dense_grid_corners(const float* ind, const float* grid,
                                       const float* g, float* g_ind,
                                       int* keys, float* wts, int n, int C,
                                       int D, int H, int W,
                                       cudaStream_t stream) {
  if (C < 1 || C > MAX_C) return cudaErrorInvalidValue;
  if ((int64_t)D * H * W + n > 0x7fffffff) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  dense_corners<<<(n + 255) / 256, 256, 0, stream>>>(ind, grid, g, g_ind,
                                                     keys, wts, n, C, D, H, W);
  return (int)cudaGetLastError();
}

// Steps 3 and 4: out [hw, C] (zeros from the caller) from the sorted keys
// [E], the sort's order [E], wts [E] and g [n, C]; partials is scratch of
// 2 C floats per 256 entries.
extern "C" int ls4d_plane_grad_sums(const int* skeys, const int64_t* order,
                                    const float* wts, const float* g,
                                    float* out, float* partials, int64_t E,
                                    int n, int C, int hw,
                                    cudaStream_t stream) {
  if (C < 1 || C > MAX_C) return cudaErrorInvalidValue;
  if (E <= 0) return cudaSuccess;
  if (C <= 8)
    return sums<8>(skeys, order, wts, g, out, partials, E, n, C, hw, stream);
  if (C <= 16)
    return sums<16>(skeys, order, wts, g, out, partials, E, n, C, hw, stream);
  return sums<32>(skeys, order, wts, g, out, partials, E, n, C, hw, stream);
}

extern "C" const char* ls4d_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
