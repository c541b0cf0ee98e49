// Tile-based gaussian alpha compositing, forward, for Hopper (sm_90a),
// in the rasterizer's two output layouts.
//
// Replaces the TPU kernels composite_fwd / _fwd_kernel ("tiled" layout)
// and composite_fwd_panel / _fwd_kernel_panel ("panel" layout,
// tpu.raster.layout: panel) of sings_tpu/ops/rasterizer/pallas_kernels.py
// and computes what they compute: for every tile, walk the tile's
// depth-sorted segment [offsets[t], offsets[t+1]) of the pair-feature
// array front to back and composite colour and final transmittance per
// pixel.
//
//   feats   (16, stride) f32, pair-minor rows: 0 mean_x | 1 mean_y |
//           2..4 conic a, b, c | 5..7 rgb | 8 opacity (rows 9..15 unused)
//   offsets (T + 1,) int32, T = n_tiles_y * n_tiles_x
//   grad_offsets, state
//           optional (both null, or both given): the gradient buffer's
//           (T + 1,) int32 window offsets and a (grad_cap / chunk, 4,
//           tile*tile) f32 buffer that receives each window's entry T
//           and colour sums (composite_common.cuh), the backward's
//           starting point; the training step asks for it, the
//           animation path does not
//   out     tiled: (T, 8, tile*tile) f32: rows 0..2 rgb, 3 T_final,
//           4..7 zero;
//           panel: (4, Hp, Wp) f32 image planes of rows 0..3,
//           Hp = n_tiles_y * tile, Wp = row_tiles * tile with
//           row_tiles = ceil(ntx / pw) * pw (pw = max(1, 128 / tile),
//           the TPU's 128-px panels)
//
// Rules (composite_common.cuh): a pair contributes alpha * T only while
// T * (1 - alpha) >= 1e-4. The TPU kernel evaluates that test per
// chunk-aligned window of `chunk` pairs against the exclusive product
// of every non-skipped alpha before it in the window, so a failed test
// ends the pixel's walk for the rest of that window only; the next
// window tests again against the latched T. The walk here follows the
// same windows (aligned at multiples of `chunk`), in sequential product
// form instead of exp(cumsum(log1p(-alpha))): the two differ only by
// float32 reassociation. A tile stops once every pixel has T < 1e-4
// (__syncthreads_count), the TPU's per-tile while-loop exit.
//
// Design: one CTA per tile, one thread per pixel (tile*tile threads).
// Each window's 9 used feature rows are staged cooperatively in shared
// memory; consecutive threads read consecutive pair addresses, so the
// loads coalesce. The thread that owns pixel (py, px) of tile (ty, tx)
// writes its values at the layout's address (PixelLayout). On the TPU a
// tile lives on the lane axis, so the panel kernel routes each
// sub-tile's pixel rows into a 128-px output block through selection
// matmuls and prefetches chunk 0 of every sub-tile; none of that
// carries over. For the panel layout the grid covers the padded tile
// row, so the sub-tiles past the image's last tile column walk an empty
// segment and write colour 0 and T = 1, as the TPU kernel's empty
// segments do; every element of the output is written.
//
// Bound on the H100: no matmul remains, so the work is ~25 fp32
// operations and one exp per walked pair-pixel against 67 TFLOP/s, or
// the bytes of the walked feats rows plus the output against 3.35 TB/s,
// whichever is larger; at the avatar's pair density the operations
// bound. The simple design keeps all 256 lanes busy on that arithmetic;
// double-buffered staging (cp.async / TMA) is later work.
//
// Writing the window-entry state costs four coalesced stores per pixel
// and window walked, against the walk's ~25 operations per pair-pixel of
// up to 128 pairs.
//
// The walk (alpha, termination, window staging, tile exit) lives in
// composite_common.cuh, shared with composite_bwd.cu. Built with
// -fmad=false so products and sums round like the plain PyTorch
// version, which runs each operation as its own kernel; both layouts
// run the same arithmetic, so they agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using composite::kUsedRows;

__global__ void composite_fwd_kernel(const float* __restrict__ feats,
                                     long long stride,
                                     const int* __restrict__ offsets,
                                     const int* __restrict__ grad_offsets,
                                     float* __restrict__ state,
                                     float* __restrict__ out, int tile,
                                     int chunk, int n_tiles_x, int row_tiles,
                                     composite::PixelLayout lay) {
  extern __shared__ float sm[];  // [kUsedRows][chunk]
  const composite::TilePixel tp = composite::tile_pixel(
      offsets, grad_offsets, tile, n_tiles_x, row_tiles, lay);
  const int npx = tile * tile;
  float* st = state ? state + (tp.gbase / chunk) * 4 * npx + threadIdx.x
                    : nullptr;
  float rgb[3], T;
  composite::fwd_walk(sm, feats, stride, tp.start, tp.end, chunk,
                      static_cast<float>(tp.tx) * tile,
                      static_cast<float>(tp.ty) * tile,
                      static_cast<float>(tp.px), static_cast<float>(tp.py),
                      rgb, &T, st, npx);
  float* o = out + tp.at;
  o[0] = rgb[0];
  o[lay.row] = rgb[1];
  o[2 * lay.row] = rgb[2];
  o[3 * lay.row] = T;
  for (int r = 4; r < lay.rows; ++r) o[r * lay.row] = 0.0f;
}

}  // namespace

// Launch on `stream`; row_tiles 0 writes the tiled layout, row_tiles > 0
// the panel planes over n_tiles_y * row_tiles tiles; grad_offsets and
// state null, or both given. Returns cudaGetLastError() of the launch.
extern "C" int composite_fwd_launch(const float* feats, long long stride,
                                    const int* offsets,
                                    const int* grad_offsets, float* state,
                                    float* out,
                                    int n_tiles_y, int n_tiles_x, int tile,
                                    int chunk, int row_tiles, void* stream) {
  const composite::PixelLayout lay =
      row_tiles > 0 ? composite::panel_layout(tile, n_tiles_y, row_tiles)
                    : composite::tiled_layout(tile, n_tiles_x);
  if (row_tiles <= 0) row_tiles = n_tiles_x;
  if (n_tiles_y <= 0 || row_tiles <= 0) return 0;
  const size_t smem = static_cast<size_t>(kUsedRows) * chunk * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        composite_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  composite_fwd_kernel<<<n_tiles_y * row_tiles, tile * tile, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      feats, stride, offsets, grad_offsets, state, out, tile, chunk,
      n_tiles_x, row_tiles, lay);
  return static_cast<int>(cudaGetLastError());
}
