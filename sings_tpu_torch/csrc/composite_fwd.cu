// Tile-based gaussian alpha compositing, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel composite_fwd / _fwd_kernel of
// sings_tpu/ops/rasterizer/pallas_kernels.py and computes what it
// computes: for every 16x16 tile, walk the tile's depth-sorted segment
// [offsets[t], offsets[t+1]) of the pair-feature array front to back
// and composite colour and final transmittance per pixel.
//
//   feats   (16, stride) f32, pair-minor rows: 0 mean_x | 1 mean_y |
//           2..4 conic a, b, c | 5..7 rgb | 8 opacity (rows 9..15 unused)
//   offsets (T + 1,) int32
//   out     (T, 8, tile*tile) f32: rows 0..2 rgb, 3 T_final, 4..7 zero
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
// loads coalesce. Bound on the H100: no matmul remains, so the work is
// ~25 fp32 operations and one exp per walked pair-pixel against
// 67 TFLOP/s, or the bytes of the walked feats rows plus the output
// against 3.35 TB/s, whichever is larger; at the avatar's pair density
// the operations bound. The simple design keeps all 256 lanes busy on
// that arithmetic; double-buffered staging (cp.async / TMA) and
// image-layout output are later work.
//
// The alpha and termination arithmetic lives in composite_common.cuh,
// shared with composite_bwd.cu. Built with -fmad=false so products and
// sums round like the plain PyTorch version, which runs each operation
// as its own kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using composite::kTEps;
using composite::kUsedRows;

__global__ void composite_fwd_kernel(const float* __restrict__ feats,
                                     long long stride,
                                     const int* __restrict__ offsets,
                                     float* __restrict__ out, int tile,
                                     int chunk, int n_tiles_x) {
  extern __shared__ float sm[];  // [kUsedRows][chunk]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int npx = blockDim.x;
  const float px = static_cast<float>(p % tile);
  const float py = static_cast<float>(p / tile);
  const float ox = static_cast<float>(t % n_tiles_x) * tile;
  const float oy = static_cast<float>(t / n_tiles_x) * tile;
  const int start = offsets[t];
  const int end = offsets[t + 1];
  const int base = (start / chunk) * chunk;

  float T = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int win = base; win < end; win += chunk) {
    // also the barrier that keeps the previous window's reads ahead of
    // this window's stores
    if (__syncthreads_count(T >= kTEps) == 0) break;
    composite::stage_window(sm, feats, stride, win, start, end, chunk);
    __syncthreads();
    const int lo = max(start - win, 0);
    const int hi = min(end - win, chunk);
    for (int k = lo; k < hi; ++k) {
      composite::PairAlpha a;
      if (!composite::pair_alpha(sm, chunk, k, ox, oy, px, py, &a)) continue;
      float t_after;
      // done for the rest of this window
      if (!composite::pair_composites(T, a.alpha, &t_after)) break;
      const float w = a.alpha * T;
      acc_r += w * sm[5 * chunk + k];
      acc_g += w * sm[6 * chunk + k];
      acc_b += w * sm[7 * chunk + k];
      T = t_after;
    }
  }
  float* o = out + static_cast<long long>(t) * 8 * npx + p;
  o[0] = acc_r;
  o[npx] = acc_g;
  o[2 * npx] = acc_b;
  o[3 * npx] = T;
  o[4 * npx] = 0.0f;
  o[5 * npx] = 0.0f;
  o[6 * npx] = 0.0f;
  o[7 * npx] = 0.0f;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() of the launch.
extern "C" int composite_fwd_launch(const float* feats, long long stride,
                                    const int* offsets, float* out,
                                    int n_tiles, int tile, int chunk,
                                    int n_tiles_x, void* stream) {
  if (n_tiles <= 0) return 0;
  const size_t smem = static_cast<size_t>(kUsedRows) * chunk * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        composite_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  composite_fwd_kernel<<<n_tiles, tile * tile, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      feats, stride, offsets, out, tile, chunk, n_tiles_x);
  return static_cast<int>(cudaGetLastError());
}
