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
// Window-entry state: the forward can store, at the top of window c of
// tile t (before the tile-exit test), each pixel's transmittance T and
// colour sums acc_r, acc_g, acc_b in row (g, 0..3) of a (grad_cap /
// chunk, 4, tile*tile) buffer, g = grad_offsets[t] / chunk + c: the
// window numbering of the gradient buffer. With it the backward's
// windows are independent work items (bwd_kernel). At a tile exit the
// forward writes zeros to the tile's remaining windows, so every window
// below grad_offsets[T] / chunk, all that the backward reads, is
// written, and a window the walk never reached holds T = 0 and is
// skipped, as the walk's exit would skip it; the rows past those are
// left as they were (the wrapper does not zero-fill the buffer).
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
// while-loop exit. state: null, or the pixel's entry-state slot of the
// tile's first window (rows 0..3 npx floats apart, windows 4 * npx);
// the windows after an exit get zeros.
__device__ __forceinline__ void fwd_walk(float* sm,
                                         const float* __restrict__ feats,
                                         long long stride, int start, int end,
                                         int chunk, float ox, float oy,
                                         float px, float py, float* rgb,
                                         float* T_out,
                                         float* __restrict__ state,
                                         int npx) {
  const int base = (start / chunk) * chunk;
  float T = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int win = base; win < end; win += chunk) {
    if (state) {
      float* s = state + static_cast<long long>((win - base) / chunk) * 4 * npx;
      s[0] = T;
      s[npx] = acc_r;
      s[2 * npx] = acc_g;
      s[3 * npx] = acc_b;
    }
    // also the barrier that keeps the previous window's reads ahead of
    // this window's stores
    if (__syncthreads_count(T >= kTEps) == 0) {
      for (int w = win + chunk; state && w < end; w += chunk) {
        float* s = state + static_cast<long long>((w - base) / chunk) * 4 * npx;
        s[0] = s[npx] = s[2 * npx] = s[3 * npx] = 0.0f;
      }
      break;
    }
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
// At a window's entry upg = g_r acc_r + g_g acc_g + g_b acc_b from the
// forward's colour sums: the same sum, reassociated.
struct WeightedCumsum {
  float upg;
  __device__ __forceinline__ WeightedCumsum(float acc_r, float acc_g,
                                            float acc_b, const PixelGrad& pg)
      : upg(pg.g_r * acc_r + pg.g_g * acc_g + pg.g_b * acc_b) {}
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

// A window's per-warp sums: red holds kUsedRows * chunk floats per warp,
// mask one bit per (warp, pair), set where a lane of the warp
// composited the pair (only then did the warp store its sums). (r, k)
// is row r of pair k summed over the set warps in warp order: the
// warps left out hold exact zeros, whose sum it equals bit for bit.
struct WarpSums {
  const float* red;
  const unsigned* mask;
  int chunk, n_warps, words;
  __device__ __forceinline__ float operator()(int r, int k) const {
    float s = 0.0f;
    for (int w = 0; w < n_warps; ++w)
      if ((mask[w * words + (k >> 5)] >> (k & 31)) & 1u)
        s += red[(w * kUsedRows + r) * chunk + k];
    return s;
  }
};

// cp.async (sm_80+): a 16-byte copy from global to shared memory that
// bypasses the registers; src_bytes below 16 fills zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start copying the window [win, win + chunk) of the 9 used feature rows
// into sm ([row][chunk]) in 16-byte pieces (feats 16-byte aligned, its
// row stride and chunk multiples of 4 floats: the wrapper checks);
// columns at or past `width` read zero. Pairs outside the tile's segment
// are copied as they are: the walk's [lo, hi) never reads them.
// Completes at the caller's cp_async_wait; every thread of the block
// calls it.
__device__ __forceinline__ void stage_window_async(
    float* sm, const float* __restrict__ feats, long long stride, int width,
    int win, int chunk) {
  const int per_row = chunk / 4;
  for (int i = threadIdx.x; i < kUsedRows * per_row; i += blockDim.x) {
    const int row = i / per_row;
    const int q = 4 * (i - row * per_row);
    const int n = min(max(width - (win + q), 0), 4);
    const float* src = feats + row * stride + (n > 0 ? win + q : 0);
    cp_async16(sm + row * chunk + q, src, 4 * n);
  }
}

// Window g of the gradient buffer: its tile t (the last with
// grad_offsets[t] <= g * chunk, found by binary search), the window's
// first pair `win` and the walk's range [lo, hi) of the tile's segment.
struct Window {
  int t, win, lo, hi;
};

__device__ __forceinline__ Window window_at(int g, const int* offsets,
                                            const int* grad_offsets,
                                            int n_tiles, int chunk) {
  const int slot = g * chunk;
  int lo = 0, hi = n_tiles;  // grad_offsets[lo] <= slot < grad_offsets[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (__ldg(&grad_offsets[mid]) <= slot) lo = mid; else hi = mid;
  }
  Window w;
  w.t = lo;
  const int start = __ldg(&offsets[lo]);
  const int end = __ldg(&offsets[lo + 1]);
  w.win = (start / chunk) * chunk + (slot - __ldg(&grad_offsets[lo]));
  w.lo = max(start - w.win, 0);
  w.hi = min(end - w.win, chunk);
  return w;
}

// The backward, one window at a time. The formulas come from Form
// (composite_bwd.cu's Production, the experiments' forms of
// composite_bwd_variants.cu):
//   Form::Carry(acc_r, acc_g, acc_b, pg)
//                  the pixel's running sums at the window's entry, from
//                  the forward's colour sums there
//   Form::terms(carry, sm, chunk, k, c, px, py, pg, v)
//                  the nine terms v[0..8] of window pair k, which
//                  composites at the pixel (c)
//   Form::row(row, sm, sums, chunk, k, ox, oy)
//                  gradient row `row` of pair k from the terms' sums
//                  over the tile (WarpSums)
// Everything else is common to the forms. A persistent grid walks the
// windows g = blockIdx.x, + gridDim.x, .. < grad_offsets[T] / chunk;
// a CTA finds the window's tile (window_at), reads each pixel's entry
// T and sums from `state` and skips the window when no pixel has
// T >= 1e-4 (a window after the tile's exit holds T = 0). The next
// window's feature rows are copied with cp.async into the other half of
// a double buffer while this one is walked. In the walk, each pair's
// nine terms are summed over the warp with shuffles where a lane of the
// warp composites it (__any_sync), lane 0 then keeps the warp's sums in
// shared memory and sets the warp's bit of the pair; after the window
// one thread per (row, pair) adds the set warps' sums in warp order and
// stores the window's (9, chunk) block with coalesced stores at columns
// grads + g * chunk (row stride gstride). Pairs outside the walk's
// [lo, hi) and skipped windows are not written.
template <class Form>
__global__ void bwd_kernel(const float* __restrict__ feats, long long stride,
                           int width,
                           const int* __restrict__ offsets,
                           const int* __restrict__ grad_offsets, int n_tiles,
                           const float* __restrict__ fwd_out,
                           const float* __restrict__ gout,
                           const float* __restrict__ state,
                           float* __restrict__ grads, long long gstride,
                           int tile, int chunk, int n_tiles_x,
                           PixelLayout lay) {
  extern __shared__ float smem[];
  const int p = threadIdx.x;
  const int npx = blockDim.x;
  const int lane = p % kWarp;
  const int warp = p / kWarp;
  const int n_warps = npx / kWarp;
  const int words = (chunk + kWarp - 1) / kWarp;
  float* const buf0 = smem;
  float* const buf1 = smem + kUsedRows * chunk;
  float* const red = smem + 2 * kUsedRows * chunk;
  unsigned* const mask =
      reinterpret_cast<unsigned*>(red + n_warps * kUsedRows * chunk);
  const WarpSums sums{red, mask, chunk, n_warps, words};
  const float px = static_cast<float>(p % tile);
  const float py = static_cast<float>(p / tile);
  const long long pix = (p / tile) * lay.pix_row + p % tile;

  const int n_windows = __ldg(&grad_offsets[n_tiles]) / chunk;
  int g = blockIdx.x;
  if (g >= n_windows) return;
  Window cur = window_at(g, offsets, grad_offsets, n_tiles, chunk);
  stage_window_async(buf0, feats, stride, width, cur.win, chunk);
  cp_async_commit();
  for (int i = 0; g < n_windows; g += gridDim.x, ++i) {
    const float* st = state + static_cast<long long>(g) * 4 * npx + p;
    const float T0 = st[0];
    // also the barrier that keeps the previous window's reads of the
    // other buffer, red and mask ahead of this window's copies and stores
    const bool busy =
        __syncthreads_count(T0 >= kTEps) != 0 && cur.lo < cur.hi;
    const int gn = g + gridDim.x;
    Window nxt = cur;
    if (gn < n_windows) {
      nxt = window_at(gn, offsets, grad_offsets, n_tiles, chunk);
      stage_window_async((i & 1) ? buf0 : buf1, feats, stride, width,
                         nxt.win, chunk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this window's copies
    __syncthreads();
    if (busy) {
      const float* sm = (i & 1) ? buf1 : buf0;
      const int tx = cur.t % n_tiles_x;
      const int ty = cur.t / n_tiles_x;
      const float ox = static_cast<float>(tx) * tile;
      const float oy = static_cast<float>(ty) * tile;
      const long long at = ty * lay.tile_row + tx * lay.tile_col + pix;
      const PixelGrad pg = pixel_grad(gout + at, fwd_out + at, lay.row);
      typename Form::Carry carry(st[npx], st[2 * npx], st[3 * npx], pg);
      float T = T0;
      bool live = true;  // false after the pixel's walk stopped here
      unsigned bits = 0;
      for (int k = cur.lo; k < cur.hi; ++k) {
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
        if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
          for (int r = 0; r < kUsedRows; ++r) v[r] = warp_sum(v[r]);
          if (lane == 0) {
            float* rk = red + warp * kUsedRows * chunk + k;
#pragma unroll
            for (int r = 0; r < kUsedRows; ++r) rk[r * chunk] = v[r];
          }
          bits |= 1u << (k & 31);
        }
        if ((k & 31) == 31 || k == cur.hi - 1) {
          if (lane == 0) mask[warp * words + (k >> 5)] = bits;
          bits = 0;
        }
      }
      __syncthreads();
      float* gw = grads + static_cast<long long>(g) * chunk;
      for (int j = p; j < kUsedRows * chunk; j += npx) {
        const int row = j / chunk;
        const int k = j - row * chunk;
        if (k < cur.lo || k >= cur.hi) continue;
        gw[row * gstride + k] = Form::row(row, sm, sums, chunk, k, ox, oy);
      }
    }
    cur = nxt;
  }
  cp_async_wait<0>();
}

// Dynamic shared memory of the backward kernel: two staged windows, one
// (kUsedRows, chunk) block of warp sums and a chunk-bit mask per warp.
inline size_t bwd_smem_bytes(int chunk, int npx) {
  const int n_warps = npx / kWarp;
  return sizeof(float) * static_cast<size_t>(kUsedRows) * chunk *
             (2 + n_warps) +
         sizeof(unsigned) * static_cast<size_t>(n_warps) *
             ((chunk + kWarp - 1) / kWarp);
}

// Launch bwd_kernel<Form> on `stream` over a persistent grid: as many
// CTAs as fit on the card at once, at most one per window of the
// buffer. row_tiles 0 reads the tiled layout, row_tiles > 0 the panel
// planes (padded tile rows of row_tiles tiles). Returns the first CUDA
// error of the set-up or of the launch.
template <class Form>
int bwd_launch(const float* feats, long long stride, int width,
               const int* offsets, const int* grad_offsets,
               const float* fwd_out, const float* gout, const float* state,
               float* grads, long long gstride, int n_tiles_y, int n_tiles_x,
               int tile, int chunk, int row_tiles, cudaStream_t stream) {
  const PixelLayout lay = row_tiles > 0
                              ? panel_layout(tile, n_tiles_y, row_tiles)
                              : tiled_layout(tile, n_tiles_x);
  const long long max_windows = gstride / chunk;
  if (n_tiles_y <= 0 || n_tiles_x <= 0 || max_windows <= 0) return 0;
  const int npx = tile * tile;
  const size_t smem = bwd_smem_bytes(chunk, npx);
  cudaError_t e = cudaFuncSetAttribute(
      bwd_kernel<Form>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      bwd_kernel<Form>, npx,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long fit = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = static_cast<int>(fit < max_windows ? fit : max_windows);
  bwd_kernel<Form><<<grid, npx, smem, stream>>>(
      feats, stride, width, offsets, grad_offsets, n_tiles_y * n_tiles_x,
      fwd_out, gout, state, grads, gstride, tile, chunk, n_tiles_x, lay);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace composite
