// The gaussians' screen-space preprocess for the rasterizer, for Hopper
// (sm_90a): one forward kernel and one backward kernel.
//
// Replaces no TPU kernel. The JAX package projects with XLA code
// (sings_tpu/ops/rasterizer/common.py::preprocess, no pallas_call); the
// port did the same with torch ops: the homogeneous products, the
// quaternion's matrix, a batched 3 x 3 product and an einsum for the
// covariance, the EWA Jacobian with its two clamps, the conics, the
// radius, degree-3 SH colour and the getRect cull, some 260 launches a
// render and ~580 more in its autograd backward. At the human_complex
// animation frame (127,744 gaussians) on an H100 that was ~0.85 ms of
// device time a frame and 73% of the render's idle device time: the host
// issued small elementwise kernels while the card idled. These kernels
// were added for that. ops/rasterizer/common.py keeps the torch ops as the
// plain forward and their hand derivation as the plain backward (CPU
// tensors).
//
// Bound on the H100: bytes. The forward reads each gaussian's means,
// scales, quaternion, alive flag and its 48 SH floats (233 bytes) and
// writes the seven fields (41 bytes): ~35 MB a render at 127,744 slots,
// ~10.5 us at 3.35 TB/s. The backward reads the same inputs and the
// cotangents (36 bytes) and writes the gradients (232 bytes). What the
// design does about it: one thread a gaussian keeps every intermediate in
// registers and recomputes the forward's values in the backward (nothing
// is saved between them); a block stages its rows' SH coefficients (and,
// in the backward, their gradients) through shared memory, so that the
// 192-byte rows are read and written by whole-warp coalesced accesses; an
// odd row stride spreads a warp's rows over the banks.
//
// Arithmetic. common.py's plain forward in float32, operation for
// operation and in its order (nvcc -fmad=false), so that the fields equal
// the plain version's on the same CUDA inputs: torch's scalar divisions
// (x / c is x * (1 / c), c / x is (1 / x) * c), its clamps (NaN kept), the
// python constants rounded to float32. Where torch reduces (the two
// homogeneous products, the quaternion's and the direction's norms, the
// covariance's batched product and einsum) the sums follow the order of
// torch's CUDA kernels on the H100: cuBLAS's one fma a term in order
// of the inner index; the norms' squares (x0^2 + x2^2) + (x1^2 + x3^2)
// and (x0^2 + x2^2) + x1^2.
// The backward is the derivation of common.py's preprocess_bwd_plain,
// with JAX's tie rules: half the cotangent at a tangent's clamp bound, at
// an SH colour of exactly 0 and at the quaternion norm's 1e-12 floor;
// all of it at the direction norm's floor (torch.clamp_min); none through
// a zero norm. No atomics: every gradient is one thread's, so two calls
// give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

// The launchers' argument, at namespace scope so that the extern "C"
// launchers keep external linkage; every field 8 bytes (ctypes mirrors it
// in ops/rasterizer/common.py). Every tensor contiguous but the
// cotangents (element strides).
struct PreprocessArgs {
  const float* means;    // (N, 3)
  const float* scales;   // (N, 3)
  const float* quats;    // (N, 4) scalar-first
  const float* sh;       // (N, K, 3), or null: RGB features
  const unsigned char* alive;  // (N,) bool, or null
  const float* view;     // (4, 4) row-vector world to camera
  const float* proj;     // (4, 4) world to clip
  const float* cam;      // (3,) camera centre
  long long n, k, deg, tile, ntx, nty;
  double smod, fx, fy, limx, limy, width, height;  // float32 values
  // the forward's fields
  float* means2d;        // (N, 2)
  float* depths;         // (N,)
  float* conics;         // (N, 3)
  float* colors;         // (N, 3), written where sh is given
  int* radii;            // (N,)
  unsigned char* mask;   // (N,) bool
  // the backward's cotangents (null: zero) and gradients
  const float* g_means2d;
  long long gm_s0, gm_s1;
  const float* g_depths;
  long long gd_s;
  const float* g_conics;
  long long gk_s0, gk_s1;
  const float* g_colors;
  long long gc_s0, gc_s1;
  float* d_means;        // (N, 3)
  float* d_scales;       // (N, 3)
  float* d_quats;        // (N, 4)
  float* d_sh;           // (N, K, 3), or null: not wanted
};

namespace {

constexpr int kThreads = 128;
// a staged row: up to 16 coefficients x 3 floats, and one more (odd)
constexpr int kStride = 49;

// python floats as torch rounds them for float32 operands
#define F32(x) static_cast<float>(x)

// sings_tpu_torch/ops/sh.py
__device__ __forceinline__ float c0() { return F32(0.28209479177387814); }
__device__ __forceinline__ float c1() { return F32(0.4886025119029199); }
__device__ __constant__ float kC2[5] = {
    F32(1.0925484305920792), F32(-1.0925484305920792),
    F32(0.31539156525252005), F32(-1.0925484305920792),
    F32(0.5462742152960396)};
__device__ __constant__ float kC3[7] = {
    F32(-0.5900435899266435), F32(2.890611442640554),
    F32(-0.4570457994644658), F32(0.3731763325901154),
    F32(-0.4570457994644658), F32(1.445305721320277),
    F32(-0.5900435899266435)};

// torch.clamp / clamp_min with scalar bounds: a NaN stays
__device__ __forceinline__ float t_clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// ops/clip.py::clip_factor: d clip(x, lo, hi) / dx as JAX has it
__device__ __forceinline__ float clip_factor(float x, float lo, float hi) {
  const float f = x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
  const float y = t_clamp_min(x, lo);
  return f * (y < hi ? 1.0f : (y == hi ? 0.5f : 0.0f));
}
__device__ __forceinline__ float floor_factor(float x, float lo) {
  return x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
}

// column c of p_hom4 @ m (torch's GEMM): the products in order of the
// inner index, one fma each
__device__ __forceinline__ float hom_col(const float* m, float x, float y,
                                         float z, int c) {
  float acc = x * m[c];
  acc = __fmaf_rn(y, m[4 + c], acc);
  acc = __fmaf_rn(z, m[8 + c], acc);
  return __fmaf_rn(1.0f, m[12 + c], acc);
}

// torch.linalg.norm over a last dim of 4 and of 3 (its CUDA reduction's
// order on the H100: squares paired across the halves, then summed)
__device__ __forceinline__ float norm4(float a, float b, float c, float d) {
  return sqrtf((a * a + c * c) + (b * b + d * d));
}
__device__ __forceinline__ float norm3(float a, float b, float c) {
  return sqrtf((a * a + c * c) + b * b);
}

// what the forward and the backward both compute of one gaussian
struct Geometry {
  float pv0, pv1, z;          // p_view[:3]
  float pc0, pc1, pw;         // p_clip[0:2], p_w
  float ss[3];                // scales * scale_modifier
  float nrm, nq, qn[4];       // |q|, its floored value, q / that
  float R[9], M[9];           // rotation, R * ss (row major)
  float rx, ry, txtz, tytz, tx, ty, rz, z2;
  float j00, j02, j11, j12;
  float c00, c01, c02, c11, c12, c22;  // camera-space covariance
  float A, B, C;              // the dilated 2D covariance
  float det;
};

__device__ __forceinline__ void geometry(const PreprocessArgs& a,
                                         const float* view,
                                         const float* proj, long long i,
                                         Geometry& g) {
  const float mx = a.means[3 * i], my = a.means[3 * i + 1],
              mz = a.means[3 * i + 2];
  g.pv0 = hom_col(view, mx, my, mz, 0);
  g.pv1 = hom_col(view, mx, my, mz, 1);
  g.z = hom_col(view, mx, my, mz, 2);
  g.pc0 = hom_col(proj, mx, my, mz, 0);
  g.pc1 = hom_col(proj, mx, my, mz, 1);
  const float pc3 = hom_col(proj, mx, my, mz, 3);
  g.pw = 1.0f / (pc3 + F32(1e-7));

  const float smod = static_cast<float>(a.smod);
  for (int j = 0; j < 3; ++j) g.ss[j] = a.scales[3 * i + j] * smod;
  const float q0 = a.quats[4 * i], q1 = a.quats[4 * i + 1],
              q2 = a.quats[4 * i + 2], q3 = a.quats[4 * i + 3];
  g.nrm = norm4(q0, q1, q2, q3);
  g.nq = t_clamp_min(g.nrm, F32(1e-12));
  g.qn[0] = q0 / g.nq;
  g.qn[1] = q1 / g.nq;
  g.qn[2] = q2 / g.nq;
  g.qn[3] = q3 / g.nq;
  const float w = g.qn[0], x = g.qn[1], y = g.qn[2], z = g.qn[3];
  // ops/rotations.py::quaternion_to_matrix
  g.R[0] = 1.0f - 2.0f * (y * y + z * z);
  g.R[1] = 2.0f * (x * y - w * z);
  g.R[2] = 2.0f * (x * z + w * y);
  g.R[3] = 2.0f * (x * y + w * z);
  g.R[4] = 1.0f - 2.0f * (x * x + z * z);
  g.R[5] = 2.0f * (y * z - w * x);
  g.R[6] = 2.0f * (x * z - w * y);
  g.R[7] = 2.0f * (y * z + w * x);
  g.R[8] = 1.0f - 2.0f * (x * x + y * y);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) g.M[3 * r + c] = g.R[3 * r + c] * g.ss[c];
  // Sigma = M @ M^T (torch's batched GEMM)
  float S[9];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      float acc = g.M[3 * r] * g.M[3 * c];
      acc = __fmaf_rn(g.M[3 * r + 1], g.M[3 * c + 1], acc);
      S[3 * r + c] = __fmaf_rn(g.M[3 * r + 2], g.M[3 * c + 2], acc);
    }
  // cov_cam = W Sigma W^T with W = view[:3, :3]^T: torch.einsum's left
  // to right contractions, T = W Sigma, then T W^T
  float T[9];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      float acc = view[r] * S[c];
      acc = __fmaf_rn(view[4 + r], S[3 + c], acc);
      T[3 * r + c] = __fmaf_rn(view[8 + r], S[6 + c], acc);
    }
  float Cm[9];
  for (int r = 0; r < 3; ++r)
    for (int c = r; c < 3; ++c) {
      float acc = T[3 * r] * view[c];
      acc = __fmaf_rn(T[3 * r + 1], view[4 + c], acc);
      Cm[3 * r + c] = __fmaf_rn(T[3 * r + 2], view[8 + c], acc);
    }
  g.c00 = Cm[0];
  g.c01 = Cm[1];
  g.c02 = Cm[2];
  g.c11 = Cm[4];
  g.c12 = Cm[5];
  g.c22 = Cm[8];

  // common.py::project_cov3d_to_2d
  const float fx = static_cast<float>(a.fx), fy = static_cast<float>(a.fy);
  const float limx = static_cast<float>(a.limx),
              limy = static_cast<float>(a.limy);
  g.rx = g.pv0 / g.z;
  g.ry = g.pv1 / g.z;
  g.txtz = t_clamp(g.rx, -limx, limx);
  g.tytz = t_clamp(g.ry, -limy, limy);
  g.tx = g.txtz * g.z;
  g.ty = g.tytz * g.z;
  g.rz = 1.0f / g.z;
  g.z2 = g.z * g.z;
  g.j00 = g.rz * fx;
  g.j02 = -(g.tx * fx) / g.z2;
  g.j11 = g.rz * fy;
  g.j12 = -(g.ty * fy) / g.z2;
  const float av = g.j00 * (g.j00 * g.c00 + g.j02 * g.c02) +
                   g.j02 * (g.j00 * g.c02 + g.j02 * g.c22);
  const float bv = g.j00 * (g.j11 * g.c01 + g.j12 * g.c02) +
                   g.j02 * (g.j11 * g.c12 + g.j12 * g.c22);
  const float cv = g.j11 * (g.j11 * g.c11 + g.j12 * g.c12) +
                   g.j12 * (g.j11 * g.c12 + g.j12 * g.c22);
  g.A = av + F32(0.3);
  g.B = bv;
  g.C = cv + F32(0.3);
  g.det = g.A * g.C - g.B * g.B;
}

// the camera-to-gaussian direction of the SH colour
struct Direction {
  float d[3], dn, dnc, dir[3];
};

__device__ __forceinline__ void direction(const PreprocessArgs& a,
                                          const float* cam, long long i,
                                          Direction& r) {
  for (int j = 0; j < 3; ++j) r.d[j] = a.means[3 * i + j] - cam[j];
  r.dn = norm3(r.d[0], r.d[1], r.d[2]);
  r.dnc = t_clamp_min(r.dn, F32(1e-12));
  for (int j = 0; j < 3; ++j) r.dir[j] = r.d[j] / r.dnc;
}

// ops/sh.py::eval_sh for one colour channel, coefficients sh[3 * k]
__device__ __forceinline__ float eval_sh(int deg, const float* sh,
                                         const float* dir) {
  float res = c0() * sh[0];
  if (deg > 0) {
    const float x = dir[0], y = dir[1], z = dir[2];
    res = ((res - (c1() * y) * sh[3]) + (c1() * z) * sh[6]) -
          (c1() * x) * sh[9];
    if (deg > 1) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      res = ((((res + (kC2[0] * xy) * sh[12]) + (kC2[1] * yz) * sh[15]) +
              (kC2[2] * ((2.0f * zz - xx) - yy)) * sh[18]) +
             (kC2[3] * xz) * sh[21]) +
            (kC2[4] * (xx - yy)) * sh[24];
      if (deg > 2) {
        res = ((((((res + ((kC3[0] * y) * (3.0f * xx - yy)) * sh[27]) +
                   ((kC3[1] * xy) * z) * sh[30]) +
                  ((kC3[2] * y) * ((4.0f * zz - xx) - yy)) * sh[33]) +
                 ((kC3[3] * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy)) *
                     sh[36]) +
                ((kC3[4] * x) * ((4.0f * zz - xx) - yy)) * sh[39]) +
               ((kC3[5] * z) * (xx - yy)) * sh[42]) +
              ((kC3[6] * x) * (xx - 3.0f * yy)) * sh[45];
      }
    }
  }
  return res;
}

// the basis values and their gradients in dir (ops/sh.py::sh_basis,
// sh_basis_jacobian)
__device__ __forceinline__ void sh_basis(int deg, const float* dir,
                                         float* b, float (*db)[3]) {
  const float x = dir[0], y = dir[1], z = dir[2];
  const float C1 = c1();
  b[0] = c0();
  db[0][0] = db[0][1] = db[0][2] = 0.0f;
  if (deg < 1) return;
  b[1] = -C1 * y;
  b[2] = C1 * z;
  b[3] = -C1 * x;
  db[1][0] = 0.0f; db[1][1] = -C1; db[1][2] = 0.0f;
  db[2][0] = 0.0f; db[2][1] = 0.0f; db[2][2] = C1;
  db[3][0] = -C1; db[3][1] = 0.0f; db[3][2] = 0.0f;
  if (deg < 2) return;
  const float xx = x * x, yy = y * y, zz = z * z;
  b[4] = kC2[0] * x * y;
  b[5] = kC2[1] * y * z;
  b[6] = kC2[2] * (2.0f * zz - xx - yy);
  b[7] = kC2[3] * x * z;
  b[8] = kC2[4] * (xx - yy);
  db[4][0] = kC2[0] * y; db[4][1] = kC2[0] * x; db[4][2] = 0.0f;
  db[5][0] = 0.0f; db[5][1] = kC2[1] * z; db[5][2] = kC2[1] * y;
  db[6][0] = -2.0f * kC2[2] * x; db[6][1] = -2.0f * kC2[2] * y;
  db[6][2] = 4.0f * kC2[2] * z;
  db[7][0] = kC2[3] * z; db[7][1] = 0.0f; db[7][2] = kC2[3] * x;
  db[8][0] = 2.0f * kC2[4] * x; db[8][1] = -2.0f * kC2[4] * y;
  db[8][2] = 0.0f;
  if (deg < 3) return;
  b[9] = kC3[0] * y * (3.0f * xx - yy);
  b[10] = kC3[1] * x * y * z;
  b[11] = kC3[2] * y * (4.0f * zz - xx - yy);
  b[12] = kC3[3] * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
  b[13] = kC3[4] * x * (4.0f * zz - xx - yy);
  b[14] = kC3[5] * z * (xx - yy);
  b[15] = kC3[6] * x * (xx - 3.0f * yy);
  db[9][0] = kC3[0] * 6.0f * x * y;
  db[9][1] = kC3[0] * (3.0f * xx - 3.0f * yy);
  db[9][2] = 0.0f;
  db[10][0] = kC3[1] * y * z;
  db[10][1] = kC3[1] * x * z;
  db[10][2] = kC3[1] * x * y;
  db[11][0] = -2.0f * kC3[2] * x * y;
  db[11][1] = kC3[2] * (4.0f * zz - xx - 3.0f * yy);
  db[11][2] = 8.0f * kC3[2] * y * z;
  db[12][0] = -6.0f * kC3[3] * x * z;
  db[12][1] = -6.0f * kC3[3] * y * z;
  db[12][2] = kC3[3] * (6.0f * zz - 3.0f * xx - 3.0f * yy);
  db[13][0] = kC3[4] * (4.0f * zz - 3.0f * xx - yy);
  db[13][1] = -2.0f * kC3[4] * x * y;
  db[13][2] = 8.0f * kC3[4] * x * z;
  db[14][0] = 2.0f * kC3[5] * x * z;
  db[14][1] = -2.0f * kC3[5] * y * z;
  db[14][2] = kC3[5] * (xx - yy);
  db[15][0] = kC3[6] * (3.0f * xx - 3.0f * yy);
  db[15][1] = -6.0f * kC3[6] * x * y;
  db[15][2] = 0.0f;
}

// rows [row0, row0 + rows) of the (N, K, 3) coefficients, the first
// `len` floats of each, into s at kStride floats a row; whole-block
// coalesced reads
__device__ __forceinline__ void stage_in(float* s, const float* src,
                                         long long row0, int rows, int len,
                                         long long row_len) {
  const float* base = src + row0 * row_len;
  if (len == row_len) {
    for (int e = threadIdx.x; e < rows * len; e += kThreads) {
      const int r = e / len;
      s[r * kStride + (e - r * len)] = base[e];
    }
  } else {
    for (int e = threadIdx.x; e < rows * len; e += kThreads) {
      const int r = e / len, c = e - r * len;
      s[r * kStride + c] = base[r * row_len + c];
    }
  }
}

__device__ __forceinline__ void load_camera(const PreprocessArgs& a,
                                            float* s_cam) {
  if (threadIdx.x < 16)
    s_cam[threadIdx.x] = a.view[threadIdx.x];
  else if (threadIdx.x < 32)
    s_cam[threadIdx.x] = a.proj[threadIdx.x - 16];
  else if (threadIdx.x < 35)
    s_cam[threadIdx.x] = a.cam[threadIdx.x - 32];
}

__global__ void __launch_bounds__(kThreads)
    preprocess_fwd_kernel(const PreprocessArgs a) {
  __shared__ float s_sh[kThreads * kStride];
  __shared__ float s_cam[35];
  const long long row0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(
      a.n - row0 < kThreads ? a.n - row0 : kThreads);
  const int deg = static_cast<int>(a.deg);
  const int nb = (deg + 1) * (deg + 1);
  load_camera(a, s_cam);
  if (a.sh) stage_in(s_sh, a.sh, row0, rows, 3 * nb, 3 * a.k);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= rows) return;
  const long long i = row0 + threadIdx.x;
  const float* view = s_cam;
  const float* proj = s_cam + 16;

  Geometry g;
  geometry(a, view, proj, i, g);
  const bool in_front = g.z > F32(0.2);
  const bool det_ok = g.det != 0.0f;
  const float ds = det_ok ? g.det : 1.0f;
  a.conics[3 * i] = g.C / ds;
  a.conics[3 * i + 1] = -g.B / ds;
  a.conics[3 * i + 2] = g.A / ds;
  const float mid = 0.5f * (g.A + g.C);
  const float lam1 = mid + sqrtf(t_clamp_min(mid * mid - g.det, F32(0.1)));
  const float radius_f = ceilf(3.0f * sqrtf(t_clamp_min(lam1, 0.0f)));
  const float width = static_cast<float>(a.width),
              height = static_cast<float>(a.height);
  const float m0 = ((g.pc0 * g.pw + 1.0f) * width - 1.0f) * 0.5f;
  const float m1 = ((g.pc1 * g.pw + 1.0f) * height - 1.0f) * 0.5f;
  a.means2d[2 * i] = m0;
  a.means2d[2 * i + 1] = m1;
  a.depths[i] = g.z;

  if (a.sh) {
    Direction dr;
    direction(a, s_cam + 32, i, dr);
    const float* sh = s_sh + threadIdx.x * kStride;
    for (int c = 0; c < 3; ++c)
      a.colors[3 * i + c] = t_clamp_min(eval_sh(deg, sh + c, dr.dir) + 0.5f,
                                        0.0f);
  }

  bool mask = in_front && det_ok && (!a.alive || a.alive[i]);
  int radius = mask ? static_cast<int>(radius_f) : 0;
  mask = mask && radius > 0;
  // the getRect cull (common.py): x / tile is x * (1 / tile) in torch
  const float inv_tile = 1.0f / static_cast<float>(a.tile);
  const float tile_f = static_cast<float>(a.tile);
  const float r = static_cast<float>(radius);
  const float ntx = static_cast<float>(a.ntx);
  const float nty = static_cast<float>(a.nty);
  const float x0 = t_clamp(floorf((m0 - r) * inv_tile), 0.0f, ntx);
  const float y0 = t_clamp(floorf((m1 - r) * inv_tile), 0.0f, nty);
  const float x1 =
      t_clamp(floorf((((m0 + r) + tile_f) - 1.0f) * inv_tile), 0.0f, ntx);
  const float y1 =
      t_clamp(floorf((((m1 + r) + tile_f) - 1.0f) * inv_tile), 0.0f, nty);
  mask = mask && (x1 - x0) * (y1 - y0) > 0.0f;
  a.radii[i] = mask ? radius : 0;
  a.mask[i] = mask ? 1 : 0;
}

// element (i, c) of a cotangent, 0 where it is absent
__device__ __forceinline__ float cot(const float* p, long long s0,
                                     long long s1, long long i, int c) {
  return p ? p[i * s0 + c * s1] : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    preprocess_bwd_kernel(const PreprocessArgs a) {
  __shared__ float s_sh[kThreads * kStride];
  __shared__ float s_cam[35];
  const long long row0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(
      a.n - row0 < kThreads ? a.n - row0 : kThreads);
  const int deg = static_cast<int>(a.deg);
  const int nb = (deg + 1) * (deg + 1);
  const bool colour = a.sh && a.g_colors;
  load_camera(a, s_cam);
  if (colour) stage_in(s_sh, a.sh, row0, rows, 3 * nb, 3 * a.k);
  __syncthreads();
  const bool live = static_cast<int>(threadIdx.x) < rows;
  const long long i = row0 + threadIdx.x;
  const float* view = s_cam;
  const float* proj = s_cam + 16;
  float* my_sh = s_sh + threadIdx.x * kStride;

  if (live) {
    Geometry g;
    geometry(a, view, proj, i, g);
    const float fx = static_cast<float>(a.fx), fy = static_cast<float>(a.fy);
    const float limx = static_cast<float>(a.limx),
                limy = static_cast<float>(a.limy);
    // means2d = ((p_clip[:2] * p_w + 1) * size - 1) / 2
    const float g_ndc0 = cot(a.g_means2d, a.gm_s0, a.gm_s1, i, 0) *
                         (0.5f * static_cast<float>(a.width));
    const float g_ndc1 = cot(a.g_means2d, a.gm_s0, a.gm_s1, i, 1) *
                         (0.5f * static_cast<float>(a.height));
    const float g_pw = g_ndc0 * g.pc0 + g_ndc1 * g.pc1;
    const float g_pc0 = g_ndc0 * g.pw, g_pc1 = g_ndc1 * g.pw;
    const float g_pc3 = -g_pw * g.pw * g.pw;

    // conics = (C, -B, A) / det, det = A C - B^2 (where det != 0)
    const float gk0 = cot(a.g_conics, a.gk_s0, a.gk_s1, i, 0);
    const float gk1 = cot(a.g_conics, a.gk_s0, a.gk_s1, i, 1);
    const float gk2 = cot(a.g_conics, a.gk_s0, a.gk_s1, i, 2);
    const bool det_ok = g.det != 0.0f;
    const float ds = det_ok ? g.det : 1.0f;
    float gA = gk2 / ds, gB = -gk1 / ds, gC = gk0 / ds;
    const float g_det =
        det_ok ? -(gk0 * g.C - gk1 * g.B + gk2 * g.A) / (ds * ds) : 0.0f;
    gA += g_det * g.C;
    gC += g_det * g.A;
    gB -= 2.0f * g_det * g.B;
    // a, b, c -> the Jacobian's four entries and cov_cam's six
    const float u0 = g.j00 * g.c00 + g.j02 * g.c02;
    const float u1 = g.j00 * g.c02 + g.j02 * g.c22;
    const float v0 = g.j11 * g.c01 + g.j12 * g.c02;
    const float v1 = g.j11 * g.c12 + g.j12 * g.c22;
    const float w0 = g.j11 * g.c11 + g.j12 * g.c12;
    const float g_j00 = 2.0f * gA * u0 + gB * v0;
    const float g_j02 = 2.0f * gA * u1 + gB * v1;
    const float g_j11 = gB * (g.j00 * g.c01 + g.j02 * g.c12) + 2.0f * gC * w0;
    const float g_j12 = gB * u1 + 2.0f * gC * v1;
    // S = gcov + gcov^T of cov_cam's upper triangle
    float S[9];
    S[0] = 2.0f * gA * g.j00 * g.j00;
    S[4] = 2.0f * gC * g.j11 * g.j11;
    S[8] = 2.0f * (gA * g.j02 * g.j02 + gB * g.j02 * g.j12 +
                   gC * g.j12 * g.j12);
    S[1] = S[3] = gB * g.j00 * g.j11;
    S[2] = S[6] = 2.0f * gA * g.j00 * g.j02 + gB * g.j00 * g.j12;
    S[5] = S[7] = gB * g.j02 * g.j11 + 2.0f * gC * g.j11 * g.j12;
    // G = W^T S W = Vr S Vr^T (Vr = view[:3, :3]): Sigma's cotangent plus
    // its transpose; then gM = G M
    float T[9], G[9], gM[9];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        T[3 * r + c] = view[4 * r] * S[c] + view[4 * r + 1] * S[3 + c] +
                       view[4 * r + 2] * S[6 + c];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        G[3 * r + c] = T[3 * r] * view[4 * c] + T[3 * r + 1] * view[4 * c + 1] +
                       T[3 * r + 2] * view[4 * c + 2];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        gM[3 * r + c] = G[3 * r] * g.M[c] + G[3 * r + 1] * g.M[3 + c] +
                        G[3 * r + 2] * g.M[6 + c];
    // M = R * ss
    float gR[9], g_ss[3] = {0.0f, 0.0f, 0.0f};
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) {
        gR[3 * r + c] = gM[3 * r + c] * g.ss[c];
        g_ss[c] += gM[3 * r + c] * g.R[3 * r + c];
      }
    const float smod = static_cast<float>(a.smod);
    for (int j = 0; j < 3; ++j) a.d_scales[3 * i + j] = g_ss[j] * smod;
    // R of the normalised quaternion (w, x, y, z)
    const float w = g.qn[0], x = g.qn[1], y = g.qn[2], z = g.qn[3];
    float gq[4];
    gq[0] = 2.0f * (-z * gR[1] + y * gR[2] + z * gR[3] - x * gR[5] -
                    y * gR[6] + x * gR[7]);
    gq[1] = 2.0f * (y * gR[1] + z * gR[2] + y * gR[3] - 2.0f * x * gR[4] -
                    w * gR[5] + z * gR[6] + w * gR[7] - 2.0f * x * gR[8]);
    gq[2] = 2.0f * (-2.0f * y * gR[0] + x * gR[1] + w * gR[2] + x * gR[3] +
                    z * gR[5] - w * gR[6] + z * gR[7] - 2.0f * y * gR[8]);
    gq[3] = 2.0f * (-2.0f * z * gR[0] - w * gR[1] + x * gR[2] + w * gR[3] -
                    2.0f * z * gR[4] + y * gR[5] + x * gR[6] + y * gR[7]);
    // qn = q / clip(|q|, 1e-12): half at the floor, nothing through 0
    float q[4], dot = 0.0f;
    for (int j = 0; j < 4; ++j) {
      q[j] = a.quats[4 * i + j];
      dot += gq[j] * q[j];
    }
    const float g_nrm =
        -dot / (g.nq * g.nq) * floor_factor(g.nrm, F32(1e-12));
    const float radial = g.nrm == 0.0f ? 0.0f : g_nrm / g.nrm;
    for (int j = 0; j < 4; ++j)
      a.d_quats[4 * i + j] = gq[j] / g.nq + q[j] * radial;

    // the Jacobian -> z and the clamped tangents
    const float g_tx = -g_j02 * fx / g.z2;
    const float g_ty = -g_j12 * fy / g.z2;
    float g_z = -(g_j00 * fx + g_j11 * fy) * g.rz * g.rz +
                2.0f * (g_j02 * fx * g.tx + g_j12 * fy * g.ty) / (g.z2 * g.z);
    g_z += g_tx * g.txtz + g_ty * g.tytz;
    const float g_rx = g_tx * g.z * clip_factor(g.rx, -limx, limx);
    const float g_ry = g_ty * g.z * clip_factor(g.ry, -limy, limy);
    const float g_pv0 = g_rx / g.z, g_pv1 = g_ry / g.z;
    g_z -= (g_rx * g.rx + g_ry * g.ry) / g.z;
    const float g_pv2 = cot(a.g_depths, a.gd_s, 0, i, 0) + g_z;
    float gm[3];
    for (int j = 0; j < 3; ++j)
      gm[j] = g_pv0 * view[4 * j] + g_pv1 * view[4 * j + 1] +
              g_pv2 * view[4 * j + 2] + g_pc0 * proj[4 * j] +
              g_pc1 * proj[4 * j + 1] + g_pc3 * proj[4 * j + 3];

    // the SH colour: clip(eval_sh + 0.5, 0), half at exactly 0
    if (colour) {
      Direction dr;
      direction(a, s_cam + 32, i, dr);
      float gv[3];
      for (int c = 0; c < 3; ++c) {
        const float v = eval_sh(deg, my_sh + c, dr.dir) + 0.5f;
        gv[c] = cot(a.g_colors, a.gc_s0, a.gc_s1, i, c) *
                floor_factor(v, 0.0f);
      }
      float b[16], db[16][3];
      sh_basis(deg, dr.dir, b, db);
      float g_dir[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (k >= nb) break;
        const float s = my_sh[3 * k] * gv[0] + my_sh[3 * k + 1] * gv[1] +
                        my_sh[3 * k + 2] * gv[2];
        for (int j = 0; j < 3; ++j) g_dir[j] += s * db[k][j];
        // this row's coefficients are read: their gradients go in place
        for (int c = 0; c < 3; ++c) my_sh[3 * k + c] = b[k] * gv[c];
      }
      // dir = d / clamp_min(|d|, 1e-12): all of it at the floor
      const float dot_d =
          g_dir[0] * dr.d[0] + g_dir[1] * dr.d[1] + g_dir[2] * dr.d[2];
      const float g_dn =
          dr.dn >= F32(1e-12) ? -dot_d / (dr.dnc * dr.dnc) : 0.0f;
      const float rad = dr.dn == 0.0f ? 0.0f : g_dn / dr.dn;
      for (int j = 0; j < 3; ++j) gm[j] += g_dir[j] / dr.dnc + dr.d[j] * rad;
    }
    for (int j = 0; j < 3; ++j) a.d_means[3 * i + j] = gm[j];
  }

  if (!a.d_sh) return;
  // the coefficients' gradients, whole rows (zero past the degree's), by
  // whole-block coalesced writes
  __syncthreads();
  const int len = 3 * static_cast<int>(a.k), used = 3 * nb;
  float* out = a.d_sh + row0 * len;
  for (int e = threadIdx.x; e < rows * len; e += kThreads) {
    const int r = e / len, c = e - r * len;
    out[e] = colour && c < used ? s_sh[r * kStride + c] : 0.0f;
  }
}

}  // namespace

extern "C" int preprocess_fwd(const PreprocessArgs* a, void* stream) {
  if (a->n <= 0 || a->deg < 0 || a->deg > 3 || a->tile <= 0 ||
      (a->sh && (a->k < (a->deg + 1) * (a->deg + 1) || !a->colors)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  preprocess_fwd_kernel<<<static_cast<unsigned>((a->n + kThreads - 1) /
                                                kThreads),
                          kThreads, 0, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int preprocess_bwd(const PreprocessArgs* a, void* stream) {
  if (a->n <= 0 || a->deg < 0 || a->deg > 3 ||
      (a->sh && a->k < (a->deg + 1) * (a->deg + 1)) ||
      (a->d_sh && !a->sh))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  preprocess_bwd_kernel<<<static_cast<unsigned>((a->n + kThreads - 1) /
                                                kThreads),
                          kThreads, 0, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
