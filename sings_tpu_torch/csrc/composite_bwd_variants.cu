// The tile-compositing backward in the formulas of the TPU experiments
// that chose composite_bwd's design, for Hopper (sm_90a).
//
// Replaces the TPU kernels composite_bwd_moments / _bwd_kernel_moments
// (scripts/exp_bwd_moments.py) and run_bwd / bwd_kernel
// (scripts/exp_bwd_variants.py, variants v1, v3, v4, v2) and computes
// what they compute, on composite_bwd.cu's arguments (tiled layout) and
// into its zeroed (9, gstride) buffer at grad_offsets[t] + c * chunk:
// rows 0 d_mean_x | 1 d_mean_y | 2..4 d_conic a, b, c | 5..7 d_rgb |
// 8 d_opacity.
//
// One form template (Variant) for composite_common.cuh's bwd_kernel,
// three choices (the launch form in brackets):
//   Cumsum       PerChannelCumsum: the inclusive cumsums of w r, w g,
//                w b per channel, dl_da = sum_k g_k (c_k T - (C_k -
//                up_k) / (1 - alpha)) - gtf / (1 - alpha) (v1);
//                WeightedCumsum (composite_bwd's): the one cotangent-
//                weighted cumsum upg of w gc, dl_da = T gc - ((cfg -
//                upg) + gtf) / (1 - alpha) (v3, v4, moments)
//   kMoments     false: each pixel's nine terms of the nine rows summed
//                over the tile, with no CSE: d_mx = sum dl_dpow * -(a dx
//                + b dy), ..., d_op = sum G dl_da (v1, v3); true: the
//                six moments of dl_dpow against [1, px, py, px^2, px py,
//                py^2] and the sums of w g_k, then per pair d_mx = -(a ex
//                + b ey) with ex = mx M00 - M10, d_ca = -(mx^2 M00 -
//                2 mx M10 + M20) / 2, ... (v4, moments)
//   kRow5Guard   with kMoments, d_op = op > 1e-12 ? M00 / max(op,
//                1e-12) : 0 (moments), else M00 / max(op, 1e-6) (v4)
// v2 is v4 on this card: the TPU formed gc = rgb . g with a K=3 matmul
// instead of three multiply-adds, and here both are three
// multiply-adds. The TPU kernels' (chunk, npx) @ (npx, 8) moment
// product is nine per-pixel products summed over the tile here, by
// bwd_kernel's warp shuffles and fixed-order cross-warp sums; no library
// call.
//
// Design: composite_bwd.cu's kernel, window loop, reduction and write-out
// (composite_common.cuh's bwd_kernel and bwd_launch), so every
// form walks exactly the windows and pairs that composite_bwd walks,
// from the same window-entry state, and the forms
// and composite_bwd differ only in their formulas: the nine per-pixel
// terms (the nine rows' pixel terms, or the six moment terms and three
// colour terms) and how a pair's rows come from their sums over the
// tile (one thread per (row, pair); the moment forms combine the
// moments there). Compiled with -fmad=false, so the plain versions'
// expression order is this kernel's.
//
// Operations, counted as composite_bwd.cu's: at every walked pair-pixel
// the forward's 16 fp32 operations and the termination test (3); per
// pair-pixel that composites, w (1) and 1 / (1 - alpha) (2), then v1 59
// (three cumsums 6, dl_da 19, dl_dpow 2, the nine terms 23, their nine
// adds 9), v3 46 (gc 5, upg 2, dl_da 5, dl_dpow 2, terms 23, adds 9),
// the moment forms 34 (gc 5, upg 2, dl_da 5, dl_dpow 2, the moment
// terms 8, colour terms 3, adds 9); per written pair, the moment forms'
// combination (39). composite_bwd's form needs fewer (34 per
// compositing pair-pixel in all) for the same gradients, so the bound
// of every form is composite_bwd's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using composite::Composite;
using composite::PixelGrad;
using composite::WarpSums;

// v1's cumsum: three per-channel inclusive cumsums up_k = sum w rgb_k,
// at a window's entry the forward's colour sums (the same sums in the
// same order, bit for bit).
struct PerChannelCumsum {
  float up_r, up_g, up_b;
  __device__ __forceinline__ PerChannelCumsum(float acc_r, float acc_g,
                                              float acc_b, const PixelGrad&)
      : up_r(acc_r), up_g(acc_g), up_b(acc_b) {}
  __device__ __forceinline__ float dl_da(const float* sm, int chunk, int k,
                                         const Composite& c,
                                         const PixelGrad& pg) {
    const float c_r = sm[5 * chunk + k];
    const float c_g = sm[6 * chunk + k];
    const float c_b = sm[7 * chunk + k];
    up_r += c.w * c_r;
    up_g += c.w * c_g;
    up_b += c.w * c_b;
    return pg.g_r * (c_r * c.T - (pg.f_r - up_r) * c.inv1m) +
           pg.g_g * (c_g * c.T - (pg.f_g - up_g) * c.inv1m) +
           pg.g_b * (c_b * c.T - (pg.f_b - up_b) * c.inv1m) -
           pg.gtf * c.inv1m;
  }
};

template <class Cumsum, bool kMoments, bool kRow5Guard>
struct Variant {
  using Carry = Cumsum;

  __device__ __forceinline__ static void terms(Carry& carry, const float* sm,
                                               int chunk, int k,
                                               const Composite& c, float px,
                                               float py, const PixelGrad& pg,
                                               float* v) {
    const float dl_da = carry.dl_da(sm, chunk, k, c, pg);
    const float dl_dpow = sm[8 * chunk + k] * dl_da * c.a.gv;
    if (kMoments) {
      v[0] = dl_dpow;
      v[1] = dl_dpow * px;
      v[2] = dl_dpow * py;
      v[3] = dl_dpow * (px * px);
      v[4] = dl_dpow * (px * py);
      v[5] = dl_dpow * (py * py);
      v[6] = c.w * pg.g_r;
      v[7] = c.w * pg.g_g;
      v[8] = c.w * pg.g_b;
    } else {
      const float ca = sm[2 * chunk + k];
      const float cb = sm[3 * chunk + k];
      const float cc = sm[4 * chunk + k];
      const float dx = c.a.dx, dy = c.a.dy;
      v[0] = dl_dpow * -(ca * dx + cb * dy);
      v[1] = dl_dpow * -(cc * dy + cb * dx);
      v[2] = dl_dpow * (-0.5f * dx * dx);
      v[3] = dl_dpow * (-dx * dy);
      v[4] = dl_dpow * (-0.5f * dy * dy);
      v[5] = pg.g_r * c.w;
      v[6] = pg.g_g * c.w;
      v[7] = pg.g_b * c.w;
      v[8] = c.a.gv * dl_da;
    }
  }

  // Row r of pair k: the sum itself, or (moment forms) the moments
  // M00..M02 (sums 0..5) and colour sums (6..8) combined with the pair's
  // tile-local mean (mx, my) and conic.
  __device__ __forceinline__ static float row(int r, const float* sm,
                                              const WarpSums& sums,
                                              int chunk, int k, float ox,
                                              float oy) {
    if (!kMoments) return sums(r, k);
    if (r >= 5 && r < 8) return sums(r + 1, k);
    const float m00 = sums(0, k);
    if (r == 8) {
      const float op = sm[8 * chunk + k];
      if (kRow5Guard) return op > 1e-12f ? m00 / fmaxf(op, 1e-12f) : 0.0f;
      return m00 / fmaxf(op, 1e-6f);
    }
    const float mx = sm[k] - ox;
    const float my = sm[chunk + k] - oy;
    if (r < 2) {
      const float ex = mx * m00 - sums(1, k);
      const float ey = my * m00 - sums(2, k);
      return r == 0 ? -(sm[2 * chunk + k] * ex + sm[3 * chunk + k] * ey)
                    : -(sm[4 * chunk + k] * ey + sm[3 * chunk + k] * ex);
    }
    if (r == 2) {
      const float m10 = sums(1, k);
      const float m20 = sums(3, k);
      return -0.5f * (mx * mx * m00 - 2.0f * mx * m10 + m20);
    }
    if (r == 3) {
      const float m10 = sums(1, k);
      const float m01 = sums(2, k);
      const float m11 = sums(4, k);
      return -(mx * my * m00 - mx * m01 - my * m10 + m11);
    }
    const float m01 = sums(2, k);
    const float m02 = sums(5, k);
    return -0.5f * (my * my * m00 - 2.0f * my * m01 + m02);
  }
};

using Moments = Variant<composite::WeightedCumsum, true, true>;
using V1 = Variant<PerChannelCumsum, false, false>;
using V3 = Variant<composite::WeightedCumsum, false, false>;
using V4 = Variant<composite::WeightedCumsum, true, false>;

}  // namespace

// Launch form `form` on `stream` (tiled layout): 0 moments
// (composite_bwd_moments), 1 v1, 2 v3, 3 v4 (and v2). Returns the
// first CUDA error of the launch.
extern "C" int composite_bwd_variants_launch(
    const float* feats, long long stride, int width, const int* offsets,
    const int* grad_offsets, const float* fwd_out, const float* gout,
    const float* state, float* grads, long long gstride, int n_tiles_y,
    int n_tiles_x, int tile, int chunk, int form, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define COMPOSITE_BWD_FORM(F)                                              \
  composite::bwd_launch<F>(feats, stride, width, offsets, grad_offsets,    \
                           fwd_out, gout, state, grads, gstride, n_tiles_y, \
                           n_tiles_x, tile, chunk, 0, s)
  switch (form) {
    case 0:
      return COMPOSITE_BWD_FORM(Moments);
    case 1:
      return COMPOSITE_BWD_FORM(V1);
    case 2:
      return COMPOSITE_BWD_FORM(V3);
    case 3:
      return COMPOSITE_BWD_FORM(V4);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef COMPOSITE_BWD_FORM
}
