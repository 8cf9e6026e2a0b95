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
// What bounded the first version on this card: the shape of its walk (see
// composite_stream_chunks_backward.cu, which shares it): a butterfly per
// sum, 70 shuffles per warp and Gaussian, zero partials for unreached
// Gaussians and a 32-thread epilogue every 32 rows.
//
// Design: one block per 16x16 tile, one thread per pixel, rows [T, K, PW]
// staged 64 at a time (32 at row widths 24 and 32). The walk itself is
// `backward_walk` of composite_common.cuh: one transposed warp exchange for
// a Gaussian's 6 + C sums, a bit mask for the (warp, Gaussian) pairs with
// nothing to add, 8x4-pixel warps, the sums over the warps and the row
// stores on all 256 threads, every sum in a fixed order. This kernel gives it the tile's padded list and has
// it zero the slots [walked, K) that it did not reach. The power chain and
// the cutoffs are the forward's, so both agree on which entries are in.
//
// What bounds it now: the latency of the walk's dependent chain per warp
// (T, prefix, expf, a division, five shuffle stages), and 67 MB of gradient
// rows of which most are the zeros of unreached slots. The sums' order
// differs from the plain version's, so the two are not bit-equal.

#include "composite_common.cuh"

namespace {

using namespace ls4d;

// At row width 16 ptxas is held to the 64 registers that let an SM hold four
// blocks (left alone it takes 71 for the stream layout's kernel, and the SM
// holds three); the wider rows need more registers than that.
template <int PW>
__global__ void __launch_bounds__(BLOCK_PX, PW == 16 ? 4 : 1)
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
      static_cast<float>((tile % tiles_x) * QUAD),
      static_cast<float>((tile / tiles_x) * QUAD),
      g_out + static_cast<size_t>(tile) * (C + 1) * BLOCK_PX +
          block_pixel(tid),
      total_in[static_cast<size_t>(tile) * BLOCK_PX + block_pixel(tid)],
      d_rows + first,
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
  const dim3 block(BLOCK_PX);
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
