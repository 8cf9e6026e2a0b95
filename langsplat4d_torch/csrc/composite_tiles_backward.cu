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
// Design: one block per 16x16 tile, one thread per pixel, rows [T, K, PW]
// staged 32 at a time. The walk itself, with its warp-shuffle reductions and
// fixed sum order, is `backward_walk` of composite_common.cuh, which the
// stream layout's backward shares; this kernel gives it the tile's padded
// list and has it zero the slots [walked, K) that it did not reach. The
// power chain and the cutoffs are the forward's, so both agree on which
// entries are in.
//
// What bounds it: arithmetic and shuffles. A (Gaussian, pixel) pair costs
// the forward's work plus ~6 + 2C operations and 5 (6 + C) shuffle-adds,
// against one row read and one row written per Gaussian shared by 256
// pixels. The sums' order differs from the plain version's, so the two are
// not bit-equal.

#include "composite_common.cuh"

namespace {

using namespace ls4d;

template <int PW>
__global__ void __launch_bounds__(BWD_PX)
composite_tiles_backward_kernel(const float* __restrict__ rows,
                                const int* __restrict__ counts,
                                const float* __restrict__ g_out,
                                const float* __restrict__ total_in,
                                float* __restrict__ d_rows,
                                int K, int tiles_x, int hard) {
  constexpr int C = PW - HDR;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t first = static_cast<size_t>(tile) * K * PW;
  backward_walk<PW>(
      rows + first, min(counts[tile], K), K,
      static_cast<float>((tile % tiles_x) * BWD_TILE),
      static_cast<float>((tile / tiles_x) * BWD_TILE),
      g_out + static_cast<size_t>(tile) * (C + 1) * BWD_PX + tid,
      total_in[static_cast<size_t>(tile) * BWD_PX + tid], d_rows + first,
      hard);
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
  const dim3 block(BWD_PX);
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
