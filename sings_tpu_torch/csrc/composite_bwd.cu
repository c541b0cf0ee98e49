// Tile-based gaussian alpha compositing, backward, for Hopper (sm_90a),
// in the rasterizer's two layouts.
//
// Replaces the TPU kernels composite_bwd / _bwd_kernel ("tiled") and
// composite_bwd_panel / _bwd_kernel_panel ("panel") of
// sings_tpu/ops/rasterizer/pallas_kernels.py and computes what they
// compute: per-pair gradients of a tile's colour and transmittance
// cotangents with respect to each pair's 2D mean, conic, rgb and
// opacity, written to the aligned gradient buffer that the un-sort glue
// of ops/rasterizer/api.py gathers from.
//
//   feats        (16, stride) f32 pair features (rows as composite_fwd)
//   offsets      (T + 1,) int32 unaligned segment offsets
//   grad_offsets (T + 1,) int32 aligned gradient-region offsets
//   fwd_out      composite_fwd's output in either layout (rows 0..3 read)
//   gout         cotangents in the same layout (rows 0..2 colour,
//                3 T_final; zero outside the image in the panel planes)
//   grads        (9, gstride) f32, zero-filled by the wrapper: window c of
//                tile t writes columns grad_offsets[t] + c * chunk + k
//                rows 0 d_mean_x | 1 d_mean_y | 2..4 d_conic a, b, c |
//                5..7 d_rgb | 8 d_opacity (JAX's rows 0..8)
//
// Closed form (the TPU kernel's): walking front to back with the same
// chunk-aligned windows, termination flags and tile exit as
// composite_fwd.cu (the walk is shared in composite_common.cuh),
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
// Design: one CTA per tile, one thread per pixel, each reading its 8
// inputs at the layout's address (the TPU panel kernel's selection-
// matmul relayout and chunk-0 prefetch are not needed); each window's 9
// used feature rows are staged in shared memory as in the forward. The
// constants cfg and gtf come from one expression for both layouts (the
// TPU's two layouts differ there by ~1 ulp), so with -fmad=false the
// layouts' gradients agree bit for bit. Padding sub-tiles of the panel
// layout walk an empty segment and write nothing. The walk, the warp
// shuffles and the fixed-order cross-warp sums are composite_common.cuh's
// bwd_walk, shared with the experiments' forms of
// composite_bwd_variants.cu; this file holds the form (Production): the
// per-pixel terms and how a pair's nine rows come from their tile sums.
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

// The rasterizer's form of composite_common.cuh's bwd_walk: one
// cotangent-weighted cumsum, per-pixel terms with the u/v CSE
// (u = dl_dpow dx, v = dl_dpow dy), the conic applied per pair.
struct Production {
  using Carry = composite::WeightedCumsum;

  __device__ __forceinline__ static void terms(
      Carry& carry, const float* sm, int chunk, int k,
      const composite::Composite& c, float px, float py,
      const composite::PixelGrad& pg, float* v) {
    const float dl_da = carry.dl_da(sm, chunk, k, c, pg);
    const float dl_dpow = sm[8 * chunk + k] * dl_da * c.a.gv;
    const float u = dl_dpow * c.a.dx;
    const float vv = dl_dpow * c.a.dy;
    v[0] = u;
    v[1] = vv;
    v[2] = u * c.a.dx;
    v[3] = u * c.a.dy;
    v[4] = vv * c.a.dy;
    v[5] = pg.g_r * c.w;
    v[6] = pg.g_g * c.w;
    v[7] = pg.g_b * c.w;
    v[8] = c.a.gv * dl_da;
  }

  __device__ __forceinline__ static float row(int r, const float* sm,
                                              const float* red, int chunk,
                                              int k, int n_warps, float ox,
                                              float oy) {
    if (r < 2) {
      const float su = composite::warps_sum(red, 0, k, chunk, n_warps);
      const float sv = composite::warps_sum(red, 1, k, chunk, n_warps);
      return r == 0 ? -(sm[2 * chunk + k] * su + sm[3 * chunk + k] * sv)
                    : -(sm[4 * chunk + k] * sv + sm[3 * chunk + k] * su);
    }
    const float s = composite::warps_sum(red, r, k, chunk, n_warps);
    if (r == 2 || r == 4) return -0.5f * s;
    return r == 3 ? -s : s;
  }
};

}  // namespace

// Launch on `stream`; row_tiles 0 reads the tiled layout, row_tiles > 0
// the panel planes over n_tiles_y * row_tiles tiles. Returns
// cudaGetLastError() of the launch.
extern "C" int composite_bwd_launch(const float* feats, long long stride,
                                    const int* offsets,
                                    const int* grad_offsets,
                                    const float* fwd_out, const float* gout,
                                    float* grads, long long gstride,
                                    int n_tiles_y, int n_tiles_x, int tile,
                                    int chunk, int row_tiles, void* stream) {
  return composite::bwd_launch<Production>(
      feats, stride, offsets, grad_offsets, fwd_out, gout, grads, gstride,
      n_tiles_y, n_tiles_x, tile, chunk, row_tiles,
      static_cast<cudaStream_t>(stream));
}
