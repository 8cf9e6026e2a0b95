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
// Here one block of 256 threads is one tile, and the walk over the cell's
// list is the forward walk of composite_common.cuh with the rect test as
// its cover test, made by the thread that loaded the row's header (its
// first 32-byte sector, two 16-byte loads), with the corners decoded
// exactly and without fmod or division: y = floor(v / 256) by a multiply
// with 1/256 (a power of two: exact), x = v - 256 y (exact), for the
// integers v = x + 256 y <= 65535 that the rows hold. Only the covered rows
// get coefficients and have their features gathered, in depth order, into
// a buffer of DEPTH rows that is carried across scan passes and blended
// when it is full or the list ends: a pass keeps ~20 of its 256 candidates
// on the bench frame, so a tile blends its ~250 rows in one or two batches
// instead of a dozen. The early exit is tested before every pass.
//
// The cell lists are binned by tile rect with no ellipse cull, and about a
// fifth of the covered rows blend no pixel of the tile. The tile-list
// kernel's tile test (`quadrant_covered` with the tile as the rect) would
// drop them with the image unchanged, but here it cost more than the
// evaluations it saved: those rows mostly fail the cheap pre-test before
// expf.
//
// What bounds it: the walk over candidates, not the blend. Each of a cell's
// cell^2 tiles reads the headers of the cell's whole list (from L2 after the
// first), so the cover tests outnumber the blended rows by the share of a
// cell that a Gaussian covers; the arithmetic per kept (Gaussian, pixel)
// pair is the stream kernel's.

#include "composite_common.cuh"

namespace {

using namespace ls4d;

// Rows buffered across scan passes, by row width: as many as 48 KB of static
// shared memory hold (32 bytes of coefficients and PW - 8 floats of features
// a row), and at least a pass more than 256.
template <int PW>
constexpr int CELL_DEPTH = PW == 16 ? 512 : PW == 24 ? 384 : 320;

// The cell kernel's cover test: does the row's tile rect (h1.z, h1.w)
// cover the tile (tx, ty)?
struct CellCover {
  float tx, ty;
  __device__ bool active() const { return true; }
  __device__ bool operator()(const float4&, const float4& h1) const {
    const float min_y = floorf(h1.z * (1.0f / 256.0f));
    const float min_x = h1.z - 256.0f * min_y;
    const float max_y = floorf(h1.w * (1.0f / 256.0f));
    const float max_x = h1.w - 256.0f * max_y;
    return min_x <= tx && tx < max_x && min_y <= ty && ty < max_y;
  }
};

// Four blocks an SM at row width 16 (64 registers, no spill), with a kept
// row's features loaded right after its rect test; three blocks with the
// later gather were slower.
template <int PW>
__global__ void __launch_bounds__(BLOCK_PX, PW == 16 ? 4 : 2)
composite_cells_kernel(const float* __restrict__ cell_rows,
                       const int* __restrict__ cell_starts,
                       const float* __restrict__ bg,
                       float* __restrict__ out,
                       int cells_x, int cell, int hard) {
  constexpr int C = PW - HDR;
  const int tiles_per_cell = cell * cell;
  const int ci = blockIdx.x / tiles_per_cell;
  const int lt = blockIdx.x % tiles_per_cell;
  const int pixel = block_pixel(threadIdx.x);
  // this tile's coordinates in the tile grid
  const int tx = (ci % cells_x) * cell + lt % cell;
  const int ty = (ci / cells_x) * cell + lt / cell;
  const float ox = static_cast<float>(tx * QUAD);
  const float oy = static_cast<float>(ty * QUAD);
  const int seg_begin = cell_starts[ci];

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float asum = 0.0f;
  bool done = false;
  const CellCover cover{static_cast<float>(tx), static_cast<float>(ty)};
  forward_walk<PW, CELL_DEPTH<PW>, true>(
      cell_rows + static_cast<size_t>(seg_begin) * PW,
      cell_starts[ci + 1] - seg_begin, ox, oy,
      PixelBasis(pixel % QUAD, pixel / QUAD), cover, hard, &T, acc, &asum,
      &done);

  float* o = out + static_cast<size_t>(blockIdx.x) * (C + 1) * BLOCK_PX +
             pixel_after_walk();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    o[c * BLOCK_PX] = c < 3 ? acc[c] + bg[c] * T : acc[c];
  }
  o[C * BLOCK_PX] = asum;
}

}  // namespace

// cell_rows [M, PW] (16-byte aligned), cell_starts [n_cells + 1], bg [3] ->
// out [n_cells, cell * cell, PW - 8 + 1, 256]. Launches on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a row
// width the kernel does not take.
extern "C" int ls4d_composite_cells(const float* cell_rows,
                                    const int* cell_starts, const float* bg,
                                    float* out, int n_cells, int cells_x,
                                    int cell, int pw, int hard_cutoffs,
                                    cudaStream_t stream) {
  if (n_cells <= 0 || cell <= 0) return cudaSuccess;
  const dim3 grid(n_cells * cell * cell);
  const dim3 block(BLOCK_PX);
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
