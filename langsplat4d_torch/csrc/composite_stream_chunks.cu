// Training forward over the (tile, depth)-sorted stream for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// langsplat4d/ops/tile_composite.py:_stream_chunk_fwd_kernel (entry
// composite_stream_chunks_pallas). Each tile blends its ragged segment
// rows[starts[t] : starts[t+1]] front to back and writes accum[t, 0:C, px]
// (features; bg * T added to rgb) and accum[t, C, px] (the alpha sum,
// 1 - T). A tile with an empty segment writes bg and a zero alpha.
//
// The TPU kernel runs a sequential grid over g-wide chunks of a
// chunk-aligned stream, each chunk owned by one tile, and carries T from one
// grid step to the next in scratch memory. Here blocks run in parallel, so
// one block owns one tile and loops over the tile's whole segment with T in
// a register of the pixel's thread: the stream needs no alignment, no
// padding slots and no chunk-to-tile table, only the segment bounds. With
// hard cutoffs a pixel stops for good before the first Gaussian that would
// take T below 1e-4 (the TPU kernel resumes it at the next chunk).
//
// Design: one block of 256 threads per 16x16 tile, one thread per pixel,
// over the tile's segment with the forward walk of composite_common.cuh
// and no cover test: the stream is ellipse-culled at its build, so a slot
// that no pixel of its tile can blend is rare. A pass loads 256 rows, the
// headers by the threads that turn them into coefficients and the features
// with coalesced 16-byte loads, behind one barrier that with hard cutoffs
// also counts the pixels still blending; the blend computes the powers of
// four Gaussians ahead of the serial T chain, skips the expf of pairs far
// below alpha = 1/255, and runs on warps of 8x4 pixels. A segment has no
// capacity, so it may span many passes; row offsets are 64-bit.
//
// What bounds it: arithmetic, not bytes. A (Gaussian, pixel) pair costs one
// expf and ~20 + 2C fp32 operations, against one PW-float row per Gaussian
// and tile shared by 256 pixels; the time is the per-pixel dependent chain
// times the walked segment length, and the early exit is what cuts it. The
// launch ends with the longest segment's walk, one block on one SM.

#include "composite_common.cuh"

namespace {

using namespace ls4d;

// Three blocks an SM at row width 16 (up to 80 registers): at four ptxas
// spills.
template <int PW>
__global__ void __launch_bounds__(BLOCK_PX, PW == 16 ? 3 : 2)
composite_stream_chunks_kernel(const float* __restrict__ rows,
                               const int* __restrict__ starts,
                               const float* __restrict__ bg,
                               float* __restrict__ out,
                               int tiles_x, int hard) {
  constexpr int C = PW - HDR;
  const int tile = blockIdx.x;
  const int pixel = block_pixel(threadIdx.x);
  const float ox = static_cast<float>((tile % tiles_x) * QUAD);
  const float oy = static_cast<float>((tile / tiles_x) * QUAD);
  const int seg_begin = starts[tile];

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float asum = 0.0f;
  bool done = false;
  forward_walk<PW, FWD_PASS, false>(
      rows + static_cast<size_t>(seg_begin) * PW, starts[tile + 1] - seg_begin,
      ox, oy, PixelBasis(pixel % QUAD, pixel / QUAD), NoCover(), hard, &T,
      acc, &asum, &done);

  float* o = out + static_cast<size_t>(tile) * (C + 1) * BLOCK_PX +
             pixel_after_walk();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    o[c * BLOCK_PX] = c < 3 ? acc[c] + bg[c] * T : acc[c];
  }
  o[C * BLOCK_PX] = asum;
}

}  // namespace

// rows [B, PW] (16-byte aligned), starts [T + 1], bg [3] -> out
// [T, PW - 8 + 1, 256]. Launches on `stream`; returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for a row width the kernel does not
// take.
extern "C" int ls4d_composite_stream_chunks(const float* rows,
                                            const int* starts,
                                            const float* bg, float* out,
                                            int num_tiles, int tiles_x,
                                            int pw, int hard_cutoffs,
                                            cudaStream_t stream) {
  if (num_tiles <= 0) return cudaSuccess;
  const dim3 grid(num_tiles);
  const dim3 block(BLOCK_PX);
  switch (pw) {
    case 16:
      composite_stream_chunks_kernel<16><<<grid, block, 0, stream>>>(
          rows, starts, bg, out, tiles_x, hard_cutoffs);
      break;
    case 24:
      composite_stream_chunks_kernel<24><<<grid, block, 0, stream>>>(
          rows, starts, bg, out, tiles_x, hard_cutoffs);
      break;
    case 32:
      composite_stream_chunks_kernel<32><<<grid, block, 0, stream>>>(
          rows, starts, bg, out, tiles_x, hard_cutoffs);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
