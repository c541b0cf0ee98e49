// Tile-based gaussian alpha compositing, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel composite_bwd / _bwd_kernel of
// sings_tpu/ops/rasterizer/pallas_kernels.py and computes what it
// computes: per-pair gradients of a tile's colour and transmittance
// cotangents with respect to each pair's 2D mean, conic, rgb and
// opacity, written to the aligned gradient buffer that the un-sort glue
// of ops/rasterizer/api.py gathers from.
//
//   feats        (16, stride) f32 pair features (rows as composite_fwd)
//   offsets      (T + 1,) int32 unaligned segment offsets
//   grad_offsets (T + 1,) int32 aligned gradient-region offsets
//   fwd_out      (T, 8, npx) f32 composite_fwd's output (rows 0..3 used)
//   gout         (T, 8, npx) f32 cotangents (rows 0..2 colour, 3 T_final)
//   grads        (9, gstride) f32, zero-filled by the wrapper: window c of
//                tile t writes columns grad_offsets[t] + c * chunk + k
//                rows 0 d_mean_x | 1 d_mean_y | 2..4 d_conic a, b, c |
//                5..7 d_rgb | 8 d_opacity (JAX's rows 0..8)
//
// Closed form (the TPU kernel's): walking front to back with the same
// chunk-aligned windows, termination flags and tile exit as
// composite_fwd.cu (the arithmetic is shared in composite_common.cuh),
// with per-pixel constants cfg = sum_k g_k C_final_k and
// gtf = g_t T_final, for every pair that composites at a pixel:
//   w = alpha T_before,  gc = sum_k g_k rgb_k,  upg += w gc (inclusive)
//   dl_da = T_before gc - ((cfg - upg) + gtf) / (1 - alpha)
//   d_rgb_k += g_k w,  d_op += G dl_da,  dl_dpow = op dl_da G,
//   u = dl_dpow dx,  v = dl_dpow dy
//   d_mean = -(a su + b sv, c sv + b su),  d_conic = -(su_dx/2, su_dy,
//   sv_dy/2) with su = sum u, sv = sum v, su_dx = sum u dx, ...
// where G = exp(power) is the unclamped falloff: the derivative is taken
// as if alpha = op G even where the 0.99 clamp was active, the TPU
// kernel's (and the CUDA reference's) quirk, reproduced on purpose.
//
// Design: one CTA per tile, one thread per pixel; each window's 9 used
// feature rows are staged in shared memory as in the forward. Per pair,
// each thread's 9 contributions are summed over its warp with shuffles
// (skipped when no lane of the warp composites the pair, which is most
// warps for small splats), lane 0 keeps the warp's sums in shared
// memory, and after the window the block sums the warps in a fixed
// order and stores the window's (9, chunk) block with coalesced stores.
// Every sum runs in a fixed order, so the output is the same from run
// to run. Slots the kernel does not write (head and tail pairs outside
// the segment, windows after the tile's exit, the spare window) keep
// the wrapper's zeros.
//
// Bound on the H100: 19 fp32 operations per walked pair-pixel (the
// forward's 16 for alpha, 3 for the flag) plus 34 per pair-pixel that
// composites (25 for w, gc, upg, dl_da and the nine products, 9 adds of
// the pixel reductions) against 67 TFLOP/s, or the walked feats rows,
// the forward output and cotangents and the gradient buffer against
// 3.35 TB/s; at the avatar's pair density the operations bound. The
// shuffle tree adds 45 shuffles per pair and warp that composites it;
// moving the reduction onto fewer lanes (or a per-pair atomics layout)
// is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using composite::kTEps;
using composite::kUsedRows;

constexpr int kWarp = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void composite_bwd_kernel(const float* __restrict__ feats,
                                     long long stride,
                                     const int* __restrict__ offsets,
                                     const int* __restrict__ grad_offsets,
                                     const float* __restrict__ fwd_out,
                                     const float* __restrict__ gout,
                                     float* __restrict__ grads,
                                     long long gstride, int tile, int chunk,
                                     int n_tiles_x) {
  extern __shared__ float smem[];
  float* sm = smem;                       // [kUsedRows][chunk]
  float* red = smem + kUsedRows * chunk;  // [warp][kUsedRows][chunk]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int npx = blockDim.x;
  const int lane = p % kWarp;
  const int warp = p / kWarp;
  const int n_warps = npx / kWarp;
  const float px = static_cast<float>(p % tile);
  const float py = static_cast<float>(p / tile);
  const float ox = static_cast<float>(t % n_tiles_x) * tile;
  const float oy = static_cast<float>(t / n_tiles_x) * tile;
  const int start = offsets[t];
  const int end = offsets[t + 1];
  const int base = (start / chunk) * chunk;
  const long long gbase = grad_offsets[t];

  const float* fo = fwd_out + static_cast<long long>(t) * 8 * npx + p;
  const float* go = gout + static_cast<long long>(t) * 8 * npx + p;
  const float g_r = go[0], g_g = go[npx], g_b = go[2 * npx];
  const float cfg = g_r * fo[0] + g_g * fo[npx] + g_b * fo[2 * npx];
  const float gtf = go[3 * npx] * fo[3 * npx];

  float T = 1.0f, upg = 0.0f;
  int c = 0;
  for (int win = base; win < end; win += chunk, ++c) {
    if (__syncthreads_count(T >= kTEps) == 0) break;
    composite::stage_window(sm, feats, stride, win, start, end, chunk);
    __syncthreads();
    const int lo = max(start - win, 0);
    const int hi = min(end - win, chunk);
    bool live = true;  // false after the pixel's walk stopped in this window
    for (int k = lo; k < hi; ++k) {
      float v[kUsedRows];
#pragma unroll
      for (int r = 0; r < kUsedRows; ++r) v[r] = 0.0f;
      bool contrib = false;
      composite::PairAlpha a;
      if (live && composite::pair_alpha(sm, chunk, k, ox, oy, px, py, &a)) {
        float t_after;
        if (composite::pair_composites(T, a.alpha, &t_after)) {
          contrib = true;
          const float w = a.alpha * T;
          const float gc = sm[5 * chunk + k] * g_r + sm[6 * chunk + k] * g_g +
                           sm[7 * chunk + k] * g_b;
          upg += w * gc;
          const float inv1m = 1.0f / (1.0f - a.alpha);
          const float dl_da = T * gc - inv1m * ((cfg - upg) + gtf);
          const float dl_dpow = sm[8 * chunk + k] * dl_da * a.gv;
          const float u = dl_dpow * a.dx;
          const float vv = dl_dpow * a.dy;
          v[0] = u;
          v[1] = vv;
          v[2] = u * a.dx;
          v[3] = u * a.dy;
          v[4] = vv * a.dy;
          v[5] = g_r * w;
          v[6] = g_g * w;
          v[7] = g_b * w;
          v[8] = a.gv * dl_da;
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
      float s0 = 0.0f, s1 = 0.0f;
      const int r0 = row < 2 ? 0 : row;
      for (int w = 0; w < n_warps; ++w) {
        s0 += red[(w * kUsedRows + r0) * chunk + k];
        if (row < 2) s1 += red[(w * kUsedRows + 1) * chunk + k];
      }
      float val;
      if (row == 0) {
        val = -(sm[2 * chunk + k] * s0 + sm[3 * chunk + k] * s1);
      } else if (row == 1) {
        val = -(sm[4 * chunk + k] * s1 + sm[3 * chunk + k] * s0);
      } else if (row == 2 || row == 4) {
        val = -0.5f * s0;
      } else if (row == 3) {
        val = -s0;
      } else {
        val = s0;
      }
      gw[row * gstride + k] = val;
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() of the launch.
extern "C" int composite_bwd_launch(const float* feats, long long stride,
                                    const int* offsets,
                                    const int* grad_offsets,
                                    const float* fwd_out, const float* gout,
                                    float* grads, long long gstride,
                                    int n_tiles, int tile, int chunk,
                                    int n_tiles_x, void* stream) {
  if (n_tiles <= 0) return 0;
  const int npx = tile * tile;
  const size_t smem = static_cast<size_t>(kUsedRows) * chunk *
                      (1 + npx / kWarp) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  composite_bwd_kernel<<<n_tiles, npx, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      feats, stride, offsets, grad_offsets, fwd_out, gout, grads, gstride,
      tile, chunk, n_tiles_x);
  return static_cast<int>(cudaGetLastError());
}
