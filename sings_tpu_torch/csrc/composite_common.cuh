// Per-pair alpha, termination rule, the two front-to-back walks and the
// two output layouts, shared by composite_fwd.cu, composite_bwd.cu and
// composite_bwd_variants.cu.
// The backward walk stops exactly where the forward walk stopped (a
// pair near the 1e-4 threshold must not get a gradient that its forward
// never composited), and both layouts run the same instructions per
// pixel, so they agree bit for bit: they differ only in where a pixel's
// inputs and outputs live (PixelLayout).
//
// Rules (_chunk_alpha and the flag lines of the TPU kernels in
// sings_tpu/ops/rasterizer/pallas_kernels.py): in tile-local
// coordinates, power = -0.5 (a dx^2 + c dy^2) - b dx dy with
// dx = mean_x - px; alpha = min(0.99, op * exp(power)); the pair is
// skipped when power > 0 or alpha < 1/255. A pair that is not skipped
// composites while T * (1 - alpha) >= 1e-4; the first that fails ends
// the pixel's walk for the rest of its chunk-aligned window.
//
// Shared-memory window layout: [row][chunk] with rows 0 mean_x |
// 1 mean_y | 2..4 conic a, b, c | 5..7 rgb | 8 opacity.
#pragma once

#include <cuda_runtime.h>

namespace composite {

constexpr int kUsedRows = 9;
constexpr int kWarp = 32;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;

// Where row r (0..2 colour, 3 T_final) of pixel (py, px) of tile
// (ty, tx) lives: r * row + ty * tile_row + tx * tile_col + py * pix_row
// + px. rows: rows written by the forward (rows 4.. are zero).
//   tiled: (T, 8, tile*tile) tile rows, T = n_tiles_y * n_tiles_x;
//   panel: (4, Hp, Wp) image planes, Hp = n_tiles_y * tile,
//          Wp = row_tiles * tile (the padded tile row).
struct PixelLayout {
  long long row, tile_row, tile_col, pix_row;
  int rows;
};

inline PixelLayout tiled_layout(int tile, int n_tiles_x) {
  const long long npx = static_cast<long long>(tile) * tile;
  return {npx, n_tiles_x * 8 * npx, 8 * npx, tile, 8};
}

inline PixelLayout panel_layout(int tile, int n_tiles_y, int row_tiles) {
  const long long wp = static_cast<long long>(row_tiles) * tile;
  return {n_tiles_y * tile * wp, tile * wp, tile, wp, 4};
}

// The calling thread's tile and pixel in a grid of n_tiles_y * row_tiles
// CTAs of tile * tile threads. Tiles past the image's last tile column
// (tx >= n_tiles_x, the panel layout's padding sub-tiles) get the empty
// segment [0, 0) and gradient base 0.
struct TilePixel {
  int tx, ty, px, py;
  int start, end;
  long long gbase;
  long long at;  // offset of row 0 of this pixel in the layout
};

__device__ __forceinline__ TilePixel tile_pixel(const int* offsets,
                                                const int* grad_offsets,
                                                int tile, int n_tiles_x,
                                                int row_tiles,
                                                const PixelLayout& lay) {
  TilePixel tp;
  tp.ty = blockIdx.x / row_tiles;
  tp.tx = blockIdx.x % row_tiles;
  tp.px = threadIdx.x % tile;
  tp.py = threadIdx.x / tile;
  const bool real = tp.tx < n_tiles_x;
  const int t = tp.ty * n_tiles_x + tp.tx;
  tp.start = real ? offsets[t] : 0;
  tp.end = real ? offsets[t + 1] : 0;
  tp.gbase = (real && grad_offsets) ? grad_offsets[t] : 0;
  tp.at = tp.ty * lay.tile_row + tp.tx * lay.tile_col + tp.py * lay.pix_row +
          tp.px;
  return tp;
}

struct PairAlpha {
  float alpha;  // clamped alpha
  float gv;     // exp(power), the unclamped gaussian falloff
  float dx;     // mean_x - px, tile-local
  float dy;
};

// Alpha of window pair k at pixel (px, py) of the tile with origin
// (ox, oy). Returns false when the pair is skipped at this pixel.
__device__ __forceinline__ bool pair_alpha(const float* sm, int chunk, int k,
                                           float ox, float oy, float px,
                                           float py, PairAlpha* out) {
  const float mx = sm[k] - ox;
  const float my = sm[chunk + k] - oy;
  const float ca = sm[2 * chunk + k];
  const float cb = sm[3 * chunk + k];
  const float cc = sm[4 * chunk + k];
  const float op = sm[8 * chunk + k];
  const float dx = mx - px;
  const float dy = my - py;
  const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
  const float gv = expf(power);
  const float alpha = fminf(0.99f, op * gv);
  out->alpha = alpha;
  out->gv = gv;
  out->dx = dx;
  out->dy = dy;
  return !(power > 0.0f || alpha < kAlphaMin);
}

// Termination test of a pair that is not skipped: writes the
// transmittance after it and returns whether the pair composites.
__device__ __forceinline__ bool pair_composites(float T, float alpha,
                                                float* t_after) {
  *t_after = T * (1.0f - alpha);
  return *t_after >= kTEps;
}

// Stage the window's 9 used feature rows in shared memory; pairs
// outside the tile's segment [start, end) read as zero. All threads of
// the block take part; the caller synchronises afterwards.
__device__ __forceinline__ void stage_window(float* sm,
                                             const float* __restrict__ feats,
                                             long long stride, int win,
                                             int start, int end, int chunk) {
  for (int i = threadIdx.x; i < kUsedRows * chunk; i += blockDim.x) {
    const int row = i / chunk;
    const int idx = win + (i - row * chunk);
    sm[i] = (idx >= start && idx < end) ? feats[row * stride + idx] : 0.0f;
  }
}

// Forward walk of one tile's segment [start, end) for the calling
// thread's pixel (px, py) of the tile with origin (ox, oy): colour
// without background into rgb[3], the final transmittance into *T_out.
// Every thread of the block calls it (block barriers inside); an empty
// segment (start == end) leaves colour 0 and T = 1. A tile stops once
// every pixel has T < 1e-4 (__syncthreads_count), the TPU's per-tile
// while-loop exit.
__device__ __forceinline__ void fwd_walk(float* sm,
                                         const float* __restrict__ feats,
                                         long long stride, int start, int end,
                                         int chunk, float ox, float oy,
                                         float px, float py, float* rgb,
                                         float* T_out) {
  const int base = (start / chunk) * chunk;
  float T = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int win = base; win < end; win += chunk) {
    // also the barrier that keeps the previous window's reads ahead of
    // this window's stores
    if (__syncthreads_count(T >= kTEps) == 0) break;
    stage_window(sm, feats, stride, win, start, end, chunk);
    __syncthreads();
    const int lo = max(start - win, 0);
    const int hi = min(end - win, chunk);
    for (int k = lo; k < hi; ++k) {
      PairAlpha a;
      if (!pair_alpha(sm, chunk, k, ox, oy, px, py, &a)) continue;
      float t_after;
      // done for the rest of this window
      if (!pair_composites(T, a.alpha, &t_after)) break;
      const float w = a.alpha * T;
      acc_r += w * sm[5 * chunk + k];
      acc_g += w * sm[6 * chunk + k];
      acc_b += w * sm[7 * chunk + k];
      T = t_after;
    }
  }
  rgb[0] = acc_r;
  rgb[1] = acc_g;
  rgb[2] = acc_b;
  *T_out = T;
}

// The backward's per-pixel inputs, read at the layout's address: the
// colour cotangents g_*, the forward colour f_*, and the constants
// cfg = sum_k g_k C_final_k and gtf = g_t T_final. One expression for
// both layouts.
struct PixelGrad {
  float g_r, g_g, g_b;
  float f_r, f_g, f_b;
  float cfg, gtf;
};

__device__ __forceinline__ PixelGrad pixel_grad(const float* go,
                                                const float* fo,
                                                long long row) {
  PixelGrad pg;
  pg.g_r = go[0];
  pg.g_g = go[row];
  pg.g_b = go[2 * row];
  pg.f_r = fo[0];
  pg.f_g = fo[row];
  pg.f_b = fo[2 * row];
  pg.cfg = pg.g_r * pg.f_r + pg.g_g * pg.f_g + pg.g_b * pg.f_b;
  pg.gtf = go[3 * row] * fo[3 * row];
  return pg;
}

// A pair that composites at the calling thread's pixel.
struct Composite {
  PairAlpha a;
  float T;      // transmittance before the pair
  float w;      // alpha T
  float inv1m;  // 1 / (1 - alpha)
};

// composite_bwd's cumsum: one cotangent-weighted inclusive cumsum
// upg = sum w gc over the pixel's walk, gc = sum_k g_k rgb_k, and
//   dl_da = T gc - ((cfg - upg) + gtf) / (1 - alpha).
struct WeightedCumsum {
  float upg = 0.0f;
  __device__ __forceinline__ float dl_da(const float* sm, int chunk, int k,
                                         const Composite& c,
                                         const PixelGrad& pg) {
    const float gc = sm[5 * chunk + k] * pg.g_r + sm[6 * chunk + k] * pg.g_g +
                     sm[7 * chunk + k] * pg.g_b;
    upg += c.w * gc;
    return c.T * gc - c.inv1m * ((pg.cfg - upg) + pg.gtf);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Row r of pair k's per-warp sums, summed over the block's warps in
// warp order.
__device__ __forceinline__ float warps_sum(const float* red, int r, int k,
                                           int chunk, int n_warps) {
  float s = 0.0f;
  for (int w = 0; w < n_warps; ++w) s += red[(w * kUsedRows + r) * chunk + k];
  return s;
}

// Backward walk of one tile's segment: the same windows, flags and tile
// exit as fwd_walk. The formulas come from Form (composite_bwd.cu's
// Production, the experiments' forms of composite_bwd_variants.cu):
//   Form::Carry    the pixel's running sums over its walk
//   Form::terms(carry, sm, chunk, k, c, px, py, pg, v)
//                  the nine terms v[0..8] of window pair k, which
//                  composites at the pixel (c)
//   Form::row(row, sm, red, chunk, k, n_warps, ox, oy)
//                  gradient row `row` of pair k from the terms' sums
//                  over the tile (warps_sum)
// Everything else is common to the forms: per pair, each thread's nine
// terms are summed over its warp with shuffles (skipped when no lane of
// the warp composites the pair, which is most warps for small splats),
// lane 0 keeps the warp's sums in shared memory, and after the window
// one thread per (row, pair) combines the warps' sums in a fixed order
// and stores the window's (9, chunk) block with coalesced stores at
// columns grads + gbase + c * chunk (row stride gstride). Pairs outside
// [start, end) and windows after the exit are not written. sm holds
// kUsedRows * chunk floats, red kUsedRows * chunk per warp. Every thread
// of the block calls it; an empty segment writes nothing.
template <class Form>
__device__ __forceinline__ void bwd_walk(float* sm, float* red,
                                         const float* __restrict__ feats,
                                         long long stride, int start, int end,
                                         int chunk, float ox, float oy,
                                         float px, float py,
                                         const PixelGrad& pg,
                                         float* __restrict__ grads,
                                         long long gstride, long long gbase) {
  const int p = threadIdx.x;
  const int npx = blockDim.x;
  const int lane = p % kWarp;
  const int warp = p / kWarp;
  const int n_warps = npx / kWarp;
  const int base = (start / chunk) * chunk;

  float T = 1.0f;
  typename Form::Carry carry{};
  int c = 0;
  for (int win = base; win < end; win += chunk, ++c) {
    if (__syncthreads_count(T >= kTEps) == 0) break;
    stage_window(sm, feats, stride, win, start, end, chunk);
    __syncthreads();
    const int lo = max(start - win, 0);
    const int hi = min(end - win, chunk);
    bool live = true;  // false after the pixel's walk stopped in this window
    for (int k = lo; k < hi; ++k) {
      float v[kUsedRows];
#pragma unroll
      for (int r = 0; r < kUsedRows; ++r) v[r] = 0.0f;
      bool contrib = false;
      Composite cp;
      if (live && pair_alpha(sm, chunk, k, ox, oy, px, py, &cp.a)) {
        float t_after;
        if (pair_composites(T, cp.a.alpha, &t_after)) {
          contrib = true;
          cp.T = T;
          cp.w = cp.a.alpha * T;
          cp.inv1m = 1.0f / (1.0f - cp.a.alpha);
          Form::terms(carry, sm, chunk, k, cp, px, py, pg, v);
          T = t_after;
        } else {
          live = false;
        }
      }
      float* rk = red + warp * kUsedRows * chunk + k;
      if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
        for (int r = 0; r < kUsedRows; ++r) v[r] = warp_sum(v[r]);
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kUsedRows; ++r) rk[r * chunk] = v[r];
      }
    }
    __syncthreads();
    float* gw = grads + gbase + static_cast<long long>(c) * chunk;
    for (int i = p; i < kUsedRows * chunk; i += npx) {
      const int row = i / chunk;
      const int k = i - row * chunk;
      if (k < lo || k >= hi) continue;
      gw[row * gstride + k] =
          Form::row(row, sm, red, chunk, k, n_warps, ox, oy);
    }
  }
}

// Dynamic shared memory of the backward kernel: the staged window plus
// one (kUsedRows, chunk) reduction block per warp.
inline size_t bwd_smem_bytes(int chunk, int npx) {
  return static_cast<size_t>(kUsedRows) * chunk * (1 + npx / kWarp) *
         sizeof(float);
}

// One CTA per tile, one thread per pixel: the pixel's inputs at the
// layout's address, then bwd_walk<Form>.
template <class Form>
__global__ void bwd_kernel(const float* __restrict__ feats, long long stride,
                           const int* __restrict__ offsets,
                           const int* __restrict__ grad_offsets,
                           const float* __restrict__ fwd_out,
                           const float* __restrict__ gout,
                           float* __restrict__ grads, long long gstride,
                           int tile, int chunk, int n_tiles_x, int row_tiles,
                           PixelLayout lay) {
  extern __shared__ float smem[];
  const TilePixel tp =
      tile_pixel(offsets, grad_offsets, tile, n_tiles_x, row_tiles, lay);
  const PixelGrad pg = pixel_grad(gout + tp.at, fwd_out + tp.at, lay.row);
  bwd_walk<Form>(smem, smem + kUsedRows * chunk, feats, stride, tp.start,
                 tp.end, chunk, static_cast<float>(tp.tx) * tile,
                 static_cast<float>(tp.ty) * tile, static_cast<float>(tp.px),
                 static_cast<float>(tp.py), pg, grads, gstride, tp.gbase);
}

// Launch bwd_kernel<Form> on `stream`; row_tiles 0 reads the tiled
// layout, row_tiles > 0 the panel planes over n_tiles_y * row_tiles
// tiles. Returns cudaGetLastError() of the launch.
template <class Form>
int bwd_launch(const float* feats, long long stride, const int* offsets,
               const int* grad_offsets, const float* fwd_out,
               const float* gout, float* grads, long long gstride,
               int n_tiles_y, int n_tiles_x, int tile, int chunk,
               int row_tiles, cudaStream_t stream) {
  const PixelLayout lay = row_tiles > 0
                              ? panel_layout(tile, n_tiles_y, row_tiles)
                              : tiled_layout(tile, n_tiles_x);
  if (row_tiles <= 0) row_tiles = n_tiles_x;
  if (n_tiles_y <= 0 || row_tiles <= 0) return 0;
  const int npx = tile * tile;
  const size_t smem = bwd_smem_bytes(chunk, npx);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_kernel<Form>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bwd_kernel<Form><<<n_tiles_y * row_tiles, npx, smem, stream>>>(
      feats, stride, offsets, grad_offsets, fwd_out, gout, grads, gstride,
      tile, chunk, n_tiles_x, row_tiles, lay);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace composite
