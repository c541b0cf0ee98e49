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
//           2..4 conic a, b, c | 5..7 rgb | 8 opacity (rows 9..15 unused);
//           16-byte aligned, stride and chunk multiples of 4 floats
//   offsets (T + 1,) int32, T = n_tiles_y * n_tiles_x
//   grad_offsets
//           (T + 1,) int32: the gradient buffer's window offsets; tile
//           t's windows are grad_offsets[t] / chunk + c, c = 0, 1, ..
//   state   (grad_cap / chunk, 4, tile*tile) f32, not zero-filled: each
//           window's entry T and colour sums (composite_common.cuh); the
//           backward's starting point when the caller keeps it, else
//           scratch of the same layout
//   sync    (grad_cap / chunk + 1,) int32, zero-filled: the ticket, then
//           one hand-off flag per window (composite_common.cuh)
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
// float32 reassociation. A tile stops once every pixel has T < 1e-4 at
// a window's top (__syncthreads_count), the TPU's per-tile while-loop
// exit.
//
// Design: a grid over windows, not tiles. A tile's segment is 1-61
// windows at the avatar's frames, so one CTA walking a whole tile
// leaves the card waiting on the longest tile's pairs one after
// another. Here a persistent grid (as many CTAs of tile*tile threads,
// one per pixel, as fit at once) takes windows in (tile, window) order
// from an atomic ticket. A CTA stages its window's 9 feature rows with
// cp.async and runs every pixel's alpha and skip test over the window's
// pairs into a mask (fwd_mask): the work that does not need T, most of
// the window's. Only then does it wait for the window's entry T and
// colour sums, which window c - 1 of the tile publishes in state row
// g = grad_offsets[t] / chunk + c and flags[g] (a fence and a flag; a
// poll and a fence); a tile's first window starts from (1, 0, 0, 0) and
// writes that row itself. The chain over the mask's set bits
// (fwd_chain, its alphas recomputed four set bits at a time ahead of
// their serial updates; 3-14% of the walked pair-pixels composite at the
// avatar's frames) is then all that is serial between the windows of a
// tile, plus the hand-off. Each window writes its exit into the next
// window's row, or, the tile's last, its colour and T at the layout's
// address (PixelLayout). Tickets are taken in order, so a window's
// predecessor holds an earlier ticket and is running or done: the wait
// cannot deadlock however the CTAs are scheduled. The exit test runs on
// each window's entry T, in the window where the tile walk ran it: that
// window writes the output from its entry (the latched T) and hands on
// kTileExited; each later window of the tile writes zeros to its own
// state row and nothing to the output. Tiles without a window (empty
// segments starting at a multiple of chunk, the panel layout's padding
// sub-tiles) are written colour 0, T = 1 by the grid after its last
// ticket, so every output element is written once. T, the colour, the
// state and so the backward's flags are bit for bit those of a walk of
// the whole tile in one thread: each window starts from the same bits
// and runs the same instructions.
//
// Bound on the H100: no matmul remains, so the work is ~16 fp32
// operations and one exp per walked pair-pixel against 67 TFLOP/s, or
// the bytes of the walked feats rows plus the output against 3.35 TB/s,
// whichever is larger; at the avatar's pair density the operations
// bound. What the design leaves in the way: the longest tile's chain of
// windows, each a hand-off through L2 (a fence, a flag, a poll and the
// 4 KB entry) plus the chain over its set bits; the mask over every pair
// of a window, where a walk that knew T would stop at the first pair
// that fails (at saturated tiles, the tile walk's few pairs a window);
// and the alpha of a compositing pair computed twice.
//
// Built with -fmad=false so products and sums round like the plain
// PyTorch version, which runs each operation as its own kernel; both
// layouts run the same arithmetic, so they agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using composite::kUsedRows;
using composite::kWarp;

__global__ void fwd_window_kernel(const float* __restrict__ feats,
                                  long long stride, int width,
                                  const int* __restrict__ offsets,
                                  const int* __restrict__ grad_offsets,
                                  int n_tiles, float* state, int* sync,
                                  float* __restrict__ out, int tile,
                                  int chunk, int n_tiles_x, int n_tiles_y,
                                  int row_tiles, composite::PixelLayout lay) {
  extern __shared__ float smem[];
  __shared__ int slot[2];  // the ticket, the predecessor's flag
  const int p = threadIdx.x;
  const int npx = blockDim.x;
  float* const sm = smem;  // [kUsedRows][chunk]
  unsigned* const mask =
      reinterpret_cast<unsigned*>(smem + kUsedRows * chunk) + p;
  int* const ticket = sync;
  int* const flags = sync + 1;
  const float px = static_cast<float>(p % tile);
  const float py = static_cast<float>(p / tile);
  const long long pix = (p / tile) * lay.pix_row + p % tile;
  const int n_windows = __ldg(&grad_offsets[n_tiles]) / chunk;

  for (;;) {
    // also the barrier that keeps the previous window's reads of sm
    // ahead of this window's copies
    const int g = composite::take_ticket(ticket, &slot[0]);
    if (g >= n_windows) break;
    const composite::Window w =
        composite::window_at(g, offsets, grad_offsets, n_tiles, chunk);
    const int first = __ldg(&grad_offsets[w.t]) / chunk;
    const int last = __ldg(&grad_offsets[w.t + 1]) / chunk - 1;
    composite::stage_window_async(sm, feats, stride, width, w.win, chunk);
    composite::cp_async_commit();
    const int tx = w.t % n_tiles_x;
    const int ty = w.t / n_tiles_x;
    const float ox = static_cast<float>(tx) * tile;
    const float oy = static_cast<float>(ty) * tile;
    composite::cp_async_wait<0>();
    __syncthreads();
    composite::fwd_mask(sm, chunk, w.lo, w.hi, ox, oy, px, py, mask, npx);
    const int flag = g == first
                         ? composite::kEntryReady
                         : composite::wait_flag(&flags[g], &slot[1]);

    float* const st = state + static_cast<long long>(g) * 4 * npx + p;
    float T = 1.0f;
    float acc[3] = {0.0f, 0.0f, 0.0f};
    if (g == first) {
      st[0] = T;
      st[npx] = st[2 * npx] = st[3 * npx] = 0.0f;
    } else if (flag == composite::kEntryReady) {
      T = __ldcg(st);
      acc[0] = __ldcg(st + npx);
      acc[1] = __ldcg(st + 2 * npx);
      acc[2] = __ldcg(st + 3 * npx);
    } else {  // the tile stopped before this window
      st[0] = st[npx] = st[2 * npx] = st[3 * npx] = 0.0f;
      if (g < last)
        composite::publish(&flags[g + 1], composite::kTileExited);
      continue;
    }
    const bool stopped = __syncthreads_count(T >= composite::kTEps) == 0;
    if (!stopped)
      composite::fwd_chain(sm, chunk, mask, npx, ox, oy, px, py, &T, acc);
    if (stopped || g == last) {
      float* o = out + ty * lay.tile_row + tx * lay.tile_col + pix;
      o[0] = acc[0];
      o[lay.row] = acc[1];
      o[2 * lay.row] = acc[2];
      o[3 * lay.row] = T;
      for (int r = 4; r < lay.rows; ++r) o[r * lay.row] = 0.0f;
      if (g < last)
        composite::publish(&flags[g + 1], composite::kTileExited);
    } else {
      float* nx = st + 4 * npx;
      nx[0] = T;
      nx[npx] = acc[0];
      nx[2 * npx] = acc[1];
      nx[3 * npx] = acc[2];
      composite::publish(&flags[g + 1], composite::kEntryReady);
    }
  }

  // tiles without a window: colour 0, T = 1
  for (int u = blockIdx.x; u < n_tiles_y * row_tiles; u += gridDim.x) {
    const int ty = u / row_tiles;
    const int tx = u % row_tiles;
    if (tx < n_tiles_x) {
      const int t = ty * n_tiles_x + tx;
      if (__ldg(&grad_offsets[t + 1]) > __ldg(&grad_offsets[t])) continue;
    }
    float* o = out + ty * lay.tile_row + tx * lay.tile_col + pix;
    o[0] = o[lay.row] = o[2 * lay.row] = 0.0f;
    o[3 * lay.row] = 1.0f;
    for (int r = 4; r < lay.rows; ++r) o[r * lay.row] = 0.0f;
  }
}

}  // namespace

// Launch on `stream` over a persistent grid: as many CTAs as fit on the
// card at once, at most one per window of the buffer (max_windows =
// grad_cap / chunk). row_tiles 0 writes the tiled layout, row_tiles > 0
// the panel planes over n_tiles_y * row_tiles tiles. width: the columns
// of feats. Returns the first CUDA error of the set-up or of the launch.
extern "C" int composite_fwd_launch(const float* feats, long long stride,
                                    int width, const int* offsets,
                                    const int* grad_offsets, float* state,
                                    int* sync, float* out,
                                    long long max_windows, int n_tiles_y,
                                    int n_tiles_x, int tile, int chunk,
                                    int row_tiles, void* stream) {
  const composite::PixelLayout lay =
      row_tiles > 0 ? composite::panel_layout(tile, n_tiles_y, row_tiles)
                    : composite::tiled_layout(tile, n_tiles_x);
  if (row_tiles <= 0) row_tiles = n_tiles_x;
  if (n_tiles_y <= 0 || n_tiles_x <= 0) return 0;
  const int npx = tile * tile;
  const size_t smem = sizeof(float) * static_cast<size_t>(kUsedRows) * chunk +
                      sizeof(unsigned) * static_cast<size_t>(npx) *
                          ((chunk + kWarp - 1) / kWarp);
  cudaError_t e = cudaFuncSetAttribute(
      fwd_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fwd_window_kernel, npx, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long fit = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const long long want = max_windows > 0 ? max_windows : 1;
  const int grid = static_cast<int>(fit < want ? fit : want);
  fwd_window_kernel<<<grid, npx, smem, static_cast<cudaStream_t>(stream)>>>(
      feats, stride, width, offsets, grad_offsets, n_tiles_y * n_tiles_x,
      state, sync, out, tile, chunk, n_tiles_x, n_tiles_y, row_tiles, lay);
  return static_cast<int>(cudaGetLastError());
}
