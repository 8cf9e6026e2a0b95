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
// four independent blocks and a 16-px tile is one. Every block walks the
// whole segment of its tile with the forward walk of composite_common.cuh:
// - With hard cutoffs at 32-px tiles the walk's cover test is the quadrant
//   test (`quadrant_covered` against the block's quadrant), and only the
//   covered rows are compacted, in depth order, and blended. A dropped row
//   is one that every pixel of the quadrant would skip by the blend's own
//   rule, so it contributes exactly nothing; the kept rows blend in the same
//   order with the same arithmetic. At 16-px tiles there is no test: the
//   stream holds no pair that the same test at its build would have
//   dropped. Four blocks read a 32-px tile's rows, the later ones from L2.
// - A quadrant whose 256 pixels have stopped leaves (__syncthreads_count);
//   a quadrant beyond the image edge leaves at once. Several blocks share
//   an SM (four at row width 16), so a long segment that only a few pixels
//   still walk no longer idles the whole SM.
// - The blend (`blend_batch`) reads a Gaussian's coefficients as two
//   16-byte broadcast loads and its features as 16-byte loads, computes the
//   powers of four Gaussians ahead of the serial T chain of the first, and
//   skips the expf where power + ln_op is below ln(1/255) by a margin of
//   ~2000 ulps (the exact alpha < 1/255 test on the expf result decides the
//   rest, so no pair changes sides).
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
//
// A band of tile rows (the multi-rank render, parallel/render.py): with
// `tile_row0` > 0 the launch covers the tile rows from `tile_row0` on, tile
// t of the launch being tile t + tile_row0 * tiles_x of the image, and
// writes the band's image, `height` rows of it. The Gaussian's
// tile origin `oy` is the image's, so a band blends in the image's pixel
// coordinates, with the same operations as the whole image's launch: its
// pixels are bit-equal to the same pixels of that launch.

#include "composite_common.cuh"

namespace {

using namespace ls4d;

// `quads` is the number of quadrants along a side of a tile: 2 at 32-px
// tiles, 1 at 16-px tiles. Block 4 t + q (or t) is quadrant q of tile t.
// Three blocks an SM at row width 16 (up to 80 registers): at four ptxas
// spills. The kept rows' features are gathered after the ballot; gathering
// them before it was slower here.
template <int PW>
__global__ void __launch_bounds__(BLOCK_PX, PW == 16 ? 3 : 2)
composite_stream_kernel(const float* __restrict__ rows,
                        const int* __restrict__ starts,
                        const float* __restrict__ bg,
                        float* __restrict__ out,
                        int tiles_x, int tile_row0, int quads, int height,
                        int width, int hard) {
  constexpr int C = PW - HDR;
  const int tile = blockIdx.x / (quads * quads);
  const int quad = blockIdx.x % (quads * quads);
  const int tile_size = quads * QUAD;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  // the quadrant's first pixel, tile-local and in the image
  const int qx = (quad % quads) * QUAD;
  const int qy = (quad / quads) * QUAD;
  // in the (band's) output image
  const int x0 = tx * tile_size + qx;
  const int y0 = ty * tile_size + qy;
  if (x0 >= width || y0 >= height) return;
  const int pixel = block_pixel(threadIdx.x);
  // the tile's origin in the image
  const float ox = static_cast<float>(tx * tile_size);
  const float oy = static_cast<float>((ty + tile_row0) * tile_size);
  const int seg_begin = starts[tile];

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float asum = 0.0f;
  // a pixel beyond the image edge blends nothing
  bool done = x0 + pixel % QUAD >= width || y0 + pixel / QUAD >= height;
  // without hard cutoffs every pixel blends every Gaussian, however faint
  const RectCover cover{ox, oy, ox + static_cast<float>(qx),
                        oy + static_cast<float>(qy),
                        hard != 0 && quads > 1};
  forward_walk<PW, FWD_PASS, false>(
      rows + static_cast<size_t>(seg_begin) * PW, starts[tile + 1] - seg_begin,
      ox, oy, PixelBasis(qx + pixel % QUAD, qy + pixel / QUAD), cover, hard,
      &T, acc, &asum, &done);

  const int p = pixel_after_walk();
  const int px = x0 + p % QUAD;
  const int py = y0 + p / QUAD;
  if (px >= width || py >= height) return;
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
// take. `rows` must be 16-byte aligned. `num_tiles` tiles from tile row
// `tile_row0` on; `height` is the output's (the band's) height.
extern "C" int ls4d_composite_stream(const float* rows, const int* starts,
                                     const float* bg, float* out,
                                     int num_tiles, int tiles_x,
                                     int tile_size, int height, int width,
                                     int pw, int hard_cutoffs, int tile_row0,
                                     cudaStream_t stream) {
  if (tile_size != 16 && tile_size != 32) return cudaErrorInvalidValue;
  if (tile_row0 < 0) return cudaErrorInvalidValue;
  if (num_tiles <= 0) return cudaSuccess;
  const int quads = tile_size / QUAD;
  const dim3 grid(num_tiles * quads * quads);
  const dim3 block(BLOCK_PX);
  switch (pw) {
    case 16:
      composite_stream_kernel<16><<<grid, block, 0, stream>>>(
          rows, starts, bg, out, tiles_x, tile_row0, quads, height, width,
          hard_cutoffs);
      break;
    case 24:
      composite_stream_kernel<24><<<grid, block, 0, stream>>>(
          rows, starts, bg, out, tiles_x, tile_row0, quads, height, width,
          hard_cutoffs);
      break;
    case 32:
      composite_stream_kernel<32><<<grid, block, 0, stream>>>(
          rows, starts, bg, out, tiles_x, tile_row0, quads, height, width,
          hard_cutoffs);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
