// Cell-list compositor for NVIDIA Hopper (sm_90a): the render option that
// bins by coarse cells only.
//
// Replaces the TPU kernel langsplat4d/ops/tile_composite.py:_cell_kernel
// (entry composite_cells_pallas). A cell is cell x cell tiles. Every tile
// walks the depth-ordered candidate rows of its cell,
// cell_rows[cell_starts[c] : cell_starts[c+1]], keeps those whose tile rect
// covers it and blends them front to back; out[c, t, 0:C, px] are the
// features (bg * T added to rgb) and out[c, t, C, px] the alpha sum of local
// tile t = ly * cell + lx of cell c. There are no per-tile lists and no
// capacity: the walk ends when every pixel of the tile has stopped or the
// cell's list is exhausted.
//
// Row layout: the shared one, with the Gaussian's tile rect in the two spare
// header columns as the JAX package's cell rows hold it: column 6 =
// rect_min_x + 256 * rect_min_y, column 7 = rect_max_x + 256 * rect_max_y
// (floats, exact for tile grids below 256 a side; max is exclusive).
//
// The TPU kernel makes one grid step a cell, loops over its tiles, and folds
// the rect test into ln_op so that an uncovered row blends with alpha 0.
// Here one block is one tile and the rect test is uniform over the block, so
// it is made while staging: of each batch of 256 candidates, thread j tests
// row j's rect against the tile, a ballot and a prefix over the warps give
// the covered rows their places in depth order, and only those are copied
// to shared memory (coalesced, through the index list) and given
// coefficients. The pixel loop is the other forward kernels'
// (composite_common.cuh) and never sees an uncovered row.
//
// What bounds it: the walk over candidates, not the blend. Each of a cell's
// cell^2 tiles reads the headers of the cell's whole list (from L2 after the
// first), so the rect tests outnumber the blended rows by the share of a
// cell that a Gaussian covers; the arithmetic per covered (Gaussian, pixel)
// pair is the stream kernel's.

#include "composite_common.cuh"

namespace {

using namespace ls4d;

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;
constexpr int NW = PX / 32;
constexpr int BATCH = PX;    // candidates tested per pass, one per thread

template <int PW>
__global__ void __launch_bounds__(PX)
composite_cells_kernel(const float* __restrict__ cell_rows,
                       const int* __restrict__ cell_starts,
                       const float* __restrict__ bg,
                       float* __restrict__ out,
                       int cells_x, int cell, int hard) {
  constexpr int C = PW - HDR;
  __shared__ float s_rows[BATCH * PW];
  __shared__ float s_coef[BATCH * 8];
  __shared__ int s_idx[BATCH];     // covered rows of the batch, depth order
  __shared__ int s_cnt[NW];        // covered rows per warp

  const int tiles_per_cell = cell * cell;
  const int ci = blockIdx.x / tiles_per_cell;
  const int lt = blockIdx.x % tiles_per_cell;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this tile's coordinates in the tile grid
  const int tx = (ci % cells_x) * cell + lt % cell;
  const int ty = (ci / cells_x) * cell + lt / cell;
  const float txf = static_cast<float>(tx);
  const float tyf = static_cast<float>(ty);
  const float ox = static_cast<float>(tx * TILE);
  const float oy = static_cast<float>(ty * TILE);
  const PixelBasis basis(tid % TILE, tid / TILE);
  const int seg_begin = cell_starts[ci];
  const int count = cell_starts[ci + 1] - seg_begin;
  const float* rows = cell_rows + static_cast<size_t>(seg_begin) * PW;

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float asum = 0.0f;
  bool done = false;

  for (int b0 = 0; b0 < count; b0 += BATCH) {
    const int nb = min(BATCH, count - b0);
    // barrier before the shared buffers are overwritten; with hard cutoffs
    // it also counts the pixels still blending
    if (hard) {
      if (__syncthreads_count(!done) == 0) break;
    } else {
      __syncthreads();
    }
    const float* src = rows + static_cast<size_t>(b0) * PW;

    // thread j: does the rect of candidate j cover this tile?
    bool covered = false;
    if (tid < nb) {
      const float rect_a = src[tid * PW + 6];
      const float rect_b = src[tid * PW + 7];
      const float rminx = fmodf(rect_a, 256.0f);
      const float rminy = (rect_a - rminx) / 256.0f;
      const float rmaxx = fmodf(rect_b, 256.0f);
      const float rmaxy = (rect_b - rmaxx) / 256.0f;
      covered = rminx <= txf && txf < rmaxx && rminy <= tyf && tyf < rmaxy;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, covered);
    if (lane == 0) s_cnt[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    int n_cov = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int n = s_cnt[w];
      if (w < warp) before += n;
      n_cov += n;
    }
    if (covered) s_idx[before + __popc(ballot & ((1u << lane) - 1u))] = tid;
    __syncthreads();

    // the covered rows, in depth order, to shared memory; then their
    // coefficients, one thread per row
    for (int i = tid; i < n_cov * PW; i += PX) {
      s_rows[i] = src[s_idx[i / PW] * PW + i % PW];
    }
    __syncthreads();
    if (tid < n_cov) {
      row_coefficients(s_rows + tid * PW, ox, oy, s_coef + tid * 8);
    }
    __syncthreads();
    if (!done) {
      blend_staged<PW>(s_rows, s_coef, n_cov, basis, hard, &T, acc, &asum,
                       &done);
    }
  }

  float* o = out + static_cast<size_t>(blockIdx.x) * (C + 1) * PX + tid;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    o[c * PX] = c < 3 ? acc[c] + bg[c] * T : acc[c];
  }
  o[C * PX] = asum;
}

}  // namespace

// cell_rows [M, PW], cell_starts [n_cells + 1], bg [3] -> out
// [n_cells, cell * cell, PW - 8 + 1, 256]. Launches on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a row
// width the kernel does not take.
extern "C" int ls4d_composite_cells(const float* cell_rows,
                                    const int* cell_starts, const float* bg,
                                    float* out, int n_cells, int cells_x,
                                    int cell, int pw, int hard_cutoffs,
                                    cudaStream_t stream) {
  if (n_cells <= 0 || cell <= 0) return cudaSuccess;
  const dim3 grid(n_cells * cell * cell);
  const dim3 block(PX);
  switch (pw) {
    case 16:
      composite_cells_kernel<16><<<grid, block, 0, stream>>>(
          cell_rows, cell_starts, bg, out, cells_x, cell, hard_cutoffs);
      break;
    case 24:
      composite_cells_kernel<24><<<grid, block, 0, stream>>>(
          cell_rows, cell_starts, bg, out, cells_x, cell, hard_cutoffs);
      break;
    case 32:
      composite_cells_kernel<32><<<grid, block, 0, stream>>>(
          cell_rows, cell_starts, bg, out, cells_x, cell, hard_cutoffs);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
