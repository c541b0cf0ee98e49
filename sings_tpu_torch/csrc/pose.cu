// Posing the avatar's gaussians for Hopper (sm_90a): a skeleton kernel and a
// per-gaussian skinning kernel, each forward and backward.
//
// Replaces no TPU kernel. The JAX package poses with XLA code
// (sings_tpu/kinematics/lbs.py::batch_rigid_transform and lbs_extra,
// sings_tpu/ops/rotations.py::matrix_to_quaternion; no pallas_call), where
// jit drops every output that nothing reads. The port ran the same
// composition eagerly: smpl_forward posed all 102,182 template vertices of
// which avatar_forward reads only the joint transforms A, lbs_extra wrote a
// (B, N, 4, 4) tensor, a batched 3 x 3 product and ~45 elementwise passes
// made the quaternions, and the joint chain was a Python loop of 4 x 4
// products: ~1,150 launches a training step with autograd's backward, and
// half of the animation's device time on an H100. kinematics/pose.py keeps
// that composition, restricted to what is read, as the plain version (CPU
// tensors).
//
// Bound on the H100: bytes. At a 16-frame chunk of 127,744 gaussians with
// 52 joints the skinning reads the weights (26.6 MB), the centres and scales
// and writes xyz, rotq and scales (81.8 MB): ~111 MB, ~0.033 ms at 3.35
// TB/s; its blends are 16 x N x 52 x 12 FMAs, ~0.04 ms in fp32 if every
// weight were read. A training step (one frame, with the backward) moves
// ~60 MB. The skeleton is a few thousand operations a frame.
//
// Design. The skeleton kernel computes only A @ inv_A_t2cano (rows 0-2):
// one CTA a frame, a thread a joint for the joint's rotation (Rodrigues of
// its axis-angle row; kinematics/pose.py takes learned 6D rows to
// axis-angle by the plain version's torch ops first) and its transform,
// one thread for the chain; the joints of betas come in (kinematics/pose.py
// regresses them with smpl_forward's own ops, so they are its bits), and no
// template vertex is posed. The skinning kernel is a thread a gaussian
// looping over the frames: the frames' transforms (B <= 16 at a time) sit
// in shared memory, a tile's weight rows are staged through shared memory
// by coalesced loads (an odd row stride spreads a warp's rows over the
// banks) and read once a chunk, and the blend walks only the joints that
// some weight of the tile moves (a body gaussian's tile moves a few of the
// 52). The backward recomputes the forward in registers (nothing is saved
// but the frames' transforms); each CTA sums its gaussians' gradients of
// the transforms and of the frame terms (transl, smpl_scale, ext_tfs) in
// shared memory, in a fixed order, into one row of per-CTA partial sums;
// the skeleton's backward (one CTA over the frames) reduces the rows in
// double, walks the chain in reverse and returns the gradients of the pose
// rows and of the joints. No atomics: two calls give the same bits.
//
// Arithmetic. float32, nvcc -fmad=false, and each sum rounded as the plain
// version's torch op rounds it on an H100, so that a training frame's xyz,
// rotq and scales are its bits: Rodrigues' |v|^2 as (v0^2 + v2^2) + v1^2
// and K @ K one fma a term in order; the chain's, the rest correction's
// and A @ inv_A_t2cano's 4-term sums as two halves, each an fma on its
// first product, then added (dot4); the blend one fma a joint in order
// (zero weights add nothing); the 3 x 3 apply as an fma on the first
// product plus the last; T[:3, :3] @ rotmat_canon one fma a term in
// order, as K @ K (measured on K @ K; the cells are isotropic, where the
// product is T itself); matrix_to_quaternion's largest pivot (first
// maximum on ties), its clamps and its operations in torch's order. This
// matters: training is chaotic in these bits, and the centres a last bit
// off the reference's grew to a loss 1.7e-3 off it within 8 steps
// (complex-pool2). ext_tfs' product follows no such model (the animation
// holds it within rounding). The backward is the derivative of this
// arithmetic, not autograd's rounding; clamp ties follow torch.clamp_min
// (all of the gradient at the bound) and jnp.clip at the norms' 1e-12
// floor (half); the skeleton's backward is in double from the reduction
// on (the forward's values in float).

#include <cuda_runtime.h>
#include <stdint.h>

// The launchers' argument, at namespace scope so that the extern "C"
// launchers keep external linkage; every field 8 bytes (ctypes mirrors it in
// kinematics/pose.py). Every tensor contiguous float32 unless named.
struct PoseArgs {
  // the skeleton's inputs
  const float* go;       // (B, 3) axis-angle
  const float* bp;       // (B, bp_len): axis-angle triples
  const float* joints;   // (J, 3) the joints of betas, as smpl_forward
                         // regresses them
  const int* parents;    // (J,) int32, parents[0] = -1, parents[j] < j
  const float* rest;     // (J - 1 - nbj, 3) axis-angle, or null
  const float* inv;      // (J, 4, 4) inv_A_t2cano
  const float* transl;   // (B, 3)
  const float* sscale;   // (B,) smpl_scale, or null
  const float* etrans;   // (B, 3) ext_tfs, or null (then erot, escale too)
  const float* erot;     // (B, 3, 3)
  const float* escale;   // (B,)
  long long b, j, nbj, bp_len;
  long long scaled, ext;  // smpl_scale, ext_tfs given (the skinning reads
                          // them from frame)
  // the gaussians
  const float* xyz;      // (N, 3)
  const float* scales;   // (N, 3)
  const float* rotmat;   // (N, 3, 3), or null: the identity (isotropic)
  const float* w;        // (N, J) skinning weights
  long long n, ctas;     // ctas: the skinning kernels' grid
  // the skeleton's outputs, the skinning's inputs
  float* a;              // (B, J, 12): rows 0-2 of A @ inv_A_t2cano
  float* frame;          // (B, kFrame): the frame terms (below)
  // the skinning's outputs
  float* out_xyz;        // (B, N, 3)
  float* out_rotq;       // (B, N, 4)
  float* out_scales;     // (B, N, 3)
  // the cotangents (null: zero)
  const float* g_xyz;    // (B, N, 3)
  const float* g_rotq;   // (B, N, 4)
  const float* g_scales; // (B, N, 3)
  // the skinning backward's per-CTA sums, the skeleton backward's input
  float* partial;        // (ctas, B, J * 12 + kExtra)
  // the gradients (null: not wanted)
  float* d_xyz;          // (N, 3)
  float* d_scales;       // (N, 3)
  float* d_rotmat;       // (N, 3, 3)
  float* d_go;           // like go
  float* d_bp;           // like bp (zero past the body's rows)
  float* d_joints;       // (J, 3)
  float* d_transl;       // (B, 3)
  float* d_sscale;       // (B,)
  float* d_etrans;       // (B, 3)
  float* d_erot;         // (B, 3, 3)
  float* d_escale;       // (B,)
};

namespace {

constexpr int kMaxJoints = 64;
constexpr int kMaxFrames = 16;      // frames staged in shared memory at once
constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;
constexpr int kSkelBwdThreads = 1024;
constexpr int kRow = 12;            // rows 0-2 of a 4 x 4 transform
// a frame's terms, and the same slots of its gradient
constexpr int kTransl = 0, kScale = 3, kEtrans = 4, kEscale = 7, kErot = 8,
              kQe = 17;             // kQe: matrix_to_quaternion(erot)
constexpr int kExtra = 21;
constexpr int kFrame = 24;
constexpr int kGrow = kRow + kExtra;  // a gaussian's row of the reduction

__device__ __forceinline__ float lo_clamp(float x, float lo) {
  return x < lo ? lo : x;  // torch.clamp_min: NaN kept
}

// d clip(x, lo) / dx as jnp.clip gives it: half at the bound
__device__ __forceinline__ float clip_factor(float x, float lo) {
  return x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
}

__device__ __forceinline__ float norm4(const float* v) {
  return sqrtf((v[0] * v[0] + v[2] * v[2]) + (v[1] * v[1] + v[3] * v[3]));
}

// ---------------------------------------------------------------------------
// rotations (ops/rotations.py)

// matrix_to_quaternion's pieces: the four pivots' arguments, their roots,
// the first maximum and its candidate (unnormalised)
struct QuatPivot {
  float x[4], qa[4], c[4], den;
  int best;
};

__device__ void quat_pivot(const float* m, QuatPivot& p) {
  const float m00 = m[0], m01 = m[1], m02 = m[2];
  const float m10 = m[3], m11 = m[4], m12 = m[5];
  const float m20 = m[6], m21 = m[7], m22 = m[8];
  p.x[0] = ((1.0f + m00) + m11) + m22;
  p.x[1] = ((1.0f + m00) - m11) - m22;
  p.x[2] = ((1.0f - m00) + m11) - m22;
  p.x[3] = ((1.0f - m00) - m11) + m22;
  for (int i = 0; i < 4; ++i)
    p.qa[i] = sqrtf(lo_clamp(lo_clamp(p.x[i], 0.0f), 1e-18f));
  p.best = 0;
  for (int i = 1; i < 4; ++i)
    if (p.qa[i] > p.qa[p.best]) p.best = i;
  const float q = p.qa[p.best];
  switch (p.best) {
    case 0:
      p.c[0] = q * q; p.c[1] = m21 - m12; p.c[2] = m02 - m20;
      p.c[3] = m10 - m01;
      break;
    case 1:
      p.c[0] = m21 - m12; p.c[1] = q * q; p.c[2] = m10 + m01;
      p.c[3] = m02 + m20;
      break;
    case 2:
      p.c[0] = m02 - m20; p.c[1] = m10 + m01; p.c[2] = q * q;
      p.c[3] = m12 + m21;
      break;
    default:
      p.c[0] = m10 - m01; p.c[1] = m20 + m02; p.c[2] = m21 + m12;
      p.c[3] = q * q;
      break;
  }
  p.den = 2.0f * lo_clamp(q, 0.1f);
}

// matrix_to_quaternion: (3, 3) -> scalar-first unit quaternion
__device__ void mat_to_quat(const float* m, float* q) {
  QuatPivot p;
  quat_pivot(m, p);
  float u[4];
  for (int i = 0; i < 4; ++i) u[i] = p.c[i] / p.den;
  const float nrm = lo_clamp(norm4(u), 1e-12f);
  for (int i = 0; i < 4; ++i) q[i] = u[i] / nrm;
}

// gm += (d q / d m)^T gq
__device__ void mat_to_quat_bwd(const float* m, const float* gq, float* gm) {
  QuatPivot p;
  quat_pivot(m, p);
  float u[4];
  for (int i = 0; i < 4; ++i) u[i] = p.c[i] / p.den;
  const float l = norm4(u);
  const float nrm = lo_clamp(l, 1e-12f);
  // q = u / clip(|u|, 1e-12)
  float gu[4];
  for (int i = 0; i < 4; ++i) gu[i] = gq[i] / nrm;
  if (l > 0.0f) {
    const float gn = -((gq[0] * u[0] + gq[2] * u[2]) + (gq[1] * u[1] + gq[3] * u[3]))
                     / (nrm * nrm) * clip_factor(l, 1e-12f) / l;
    for (int i = 0; i < 4; ++i) gu[i] += u[i] * gn;
  }
  // u = c / (2 clamp_min(qa_best, 0.1))
  float gc[4];
  for (int i = 0; i < 4; ++i) gc[i] = gu[i] / p.den;
  const float gden = -((gu[0] * p.c[0] + gu[2] * p.c[2]) + (gu[1] * p.c[1] + gu[3] * p.c[3]))
                     / (p.den * p.den);
  const int b = p.best;
  const float qb = p.qa[b];
  float gqa = (qb >= 0.1f ? 2.0f * gden : 0.0f) + 2.0f * qb * gc[b];
  // qa = sqrt(clamp_min(clamp_min(x, 0), 1e-18))
  const float gx = p.x[b] >= 1e-18f ? gqa / (2.0f * qb) : 0.0f;
  // the pivots' arguments: signs of (m00, m11, m22)
  const float sgn[4][3] = {{1, 1, 1}, {1, -1, -1}, {-1, 1, -1}, {-1, -1, 1}};
  gm[0] += sgn[b][0] * gx;
  gm[4] += sgn[b][1] * gx;
  gm[8] += sgn[b][2] * gx;
  switch (b) {
    case 0:
      gm[7] += gc[1]; gm[5] -= gc[1]; gm[2] += gc[2]; gm[6] -= gc[2];
      gm[3] += gc[3]; gm[1] -= gc[3];
      break;
    case 1:
      gm[7] += gc[0]; gm[5] -= gc[0]; gm[3] += gc[2]; gm[1] += gc[2];
      gm[2] += gc[3]; gm[6] += gc[3];
      break;
    case 2:
      gm[2] += gc[0]; gm[6] -= gc[0]; gm[3] += gc[1]; gm[1] += gc[1];
      gm[5] += gc[3]; gm[7] += gc[3];
      break;
    default:
      gm[3] += gc[0]; gm[1] -= gc[0]; gm[6] += gc[1]; gm[2] += gc[1];
      gm[7] += gc[2]; gm[5] += gc[2];
      break;
  }
}

// axis_angle_to_matrix: Rodrigues, first order below |v|^2 < 1e-16
__device__ void aa_to_mat(const float* v, float* r) {
  const float sq = (v[0] * v[0] + v[2] * v[2]) + v[1] * v[1];
  if (sq < 1e-16f) {
    r[0] = 1.0f; r[1] = -v[2]; r[2] = v[1];
    r[3] = v[2]; r[4] = 1.0f; r[5] = -v[0];
    r[6] = -v[1]; r[7] = v[0]; r[8] = 1.0f;
    return;
  }
  const float angle = sqrtf(sq);
  const float safe = lo_clamp(angle, 1e-12f);
  const float x = v[0] / safe, y = v[1] / safe, z = v[2] / safe;
  const float s = sinf(angle), c = cosf(angle);
  const float k[9] = {0.0f, -z, y, z, 0.0f, -x, -y, x, 0.0f};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float kk = fmaf(k[i * 3 + 2], k[6 + j],
                            fmaf(k[i * 3 + 1], k[3 + j], k[i * 3] * k[j]));
      r[i * 3 + j] = ((i == j ? 1.0f : 0.0f) + s * k[i * 3 + j])
                     + (1.0f - c) * kk;
    }
}

// gv = (d R / d v)^T g, in double
__device__ void aa_to_mat_bwd(const float* vf, const double* g, double* gv) {
  const double v[3] = {vf[0], vf[1], vf[2]};
  // the forward's branch, decided in float
  const float sqf = (vf[0] * vf[0] + vf[2] * vf[2]) + vf[1] * vf[1];
  if (sqf < 1e-16f) {
    gv[0] = g[7] - g[5];
    gv[1] = g[2] - g[6];
    gv[2] = g[3] - g[1];
    return;
  }
  const double angle = sqrt((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2]);
  const double safe = angle < 1e-12 ? 1e-12 : angle;
  const double x = v[0] / safe, y = v[1] / safe, z = v[2] / safe;
  const double s = sin(angle), c = cos(angle);
  const double k[9] = {0.0, -z, y, z, 0.0, -x, -y, x, 0.0};
  double gs = 0.0, gomc = 0.0, gk[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const double kk = (k[i * 3] * k[j] + k[i * 3 + 1] * k[3 + j])
                        + k[i * 3 + 2] * k[6 + j];
      gs += g[i * 3 + j] * k[i * 3 + j];
      gomc += g[i * 3 + j] * kk;
      // d(K K) = dK K + K dK: g K^T + K^T g
      double t = 0.0;
      for (int m = 0; m < 3; ++m)
        t += g[i * 3 + m] * k[j * 3 + m] + k[m * 3 + i] * g[m * 3 + j];
      gk[i * 3 + j] = s * g[i * 3 + j] + (1.0 - c) * t;
    }
  const double gaxis[3] = {gk[7] - gk[5], gk[2] - gk[6], gk[3] - gk[1]};
  double gangle = gs * c + gomc * s;
  // axis = v / clamp_min(angle, 1e-12)
  const double gsafe = -((gaxis[0] * v[0] + gaxis[1] * v[1]) + gaxis[2] * v[2])
                       / (safe * safe);
  if (angle >= 1e-12) gangle += gsafe;
  for (int i = 0; i < 3; ++i) gv[i] = gaxis[i] / safe + v[i] * (gangle / angle);
}

// quaternion_raw_multiply
__device__ __forceinline__ void quat_mul(const float* a, const float* b,
                                         float* r) {
  r[0] = ((a[0] * b[0] - a[1] * b[1]) - a[2] * b[2]) - a[3] * b[3];
  r[1] = ((a[0] * b[1] + a[1] * b[0]) + a[2] * b[3]) - a[3] * b[2];
  r[2] = ((a[0] * b[2] - a[1] * b[3]) + a[2] * b[0]) + a[3] * b[1];
  r[3] = ((a[0] * b[3] + a[1] * b[2]) - a[2] * b[1]) + a[3] * b[0];
}

// ---------------------------------------------------------------------------
// the skeleton

// joint j's position
__device__ void joint_position(const PoseArgs& a, int j, float* out) {
  for (int c = 0; c < 3; ++c) out[c] = a.joints[j * 3 + c];
}

// joint j's axis-angle row in frame b: go, bp or full_pose's rest rows
__device__ const float* pose_row(const PoseArgs& a, int b, int j) {
  if (j == 0) return a.go + b * 3;
  if (j <= a.nbj) return a.bp + b * a.bp_len + (j - 1) * 3;
  return a.rest + (j - 1 - a.nbj) * 3;
}

// joint j's rotation in frame b: axis_angle_to_matrix
__device__ void joint_rotation(const PoseArgs& a, int b, int j, float* r) {
  aa_to_mat(pose_row(a, b, j), r);
}

// a 4-term product row . column as torch's 4 x 4 matmuls round it on the
// card: two halves, each one fma on the first product, then their sum
__device__ __forceinline__ float dot4(float x0, float y0, float x1, float y1,
                                      float x2, float y2, float x3,
                                      float y3) {
  return fmaf(x1, y1, x0 * y0) + fmaf(x3, y3, x2 * y2);
}

// batch_rigid_transform's chain: world_j = world_parent @ local_j, local_j
// = [R_j | J_j - J_parent; 0 0 0 1], rows 0-2
__device__ void chain_forward(const int* parents, int nj, float (*jp)[3],
                              float (*rot)[9], float (*rw)[9],
                              float (*tw)[3]) {
  for (int c = 0; c < 9; ++c) rw[0][c] = rot[0][c];
  for (int c = 0; c < 3; ++c) tw[0][c] = jp[0][c];
  for (int j = 1; j < nj; ++j) {
    const int p = parents[j];
    const float rel[3] = {jp[j][0] - jp[p][0], jp[j][1] - jp[p][1],
                          jp[j][2] - jp[p][2]};
    for (int r = 0; r < 3; ++r) {
      const float* w = rw[p] + r * 3;
      const float t = tw[p][r];
      for (int c = 0; c < 3; ++c)
        rw[j][r * 3 + c] = dot4(w[0], rot[j][c], w[1], rot[j][3 + c], w[2],
                                rot[j][6 + c], t, 0.0f);
      tw[j][r] = dot4(w[0], rel[0], w[1], rel[1], w[2], rel[2], t, 1.0f);
    }
  }
}

// rows 0-2 of A_j = [Rw | tw - [Rw | tw] (J_j, 0)], then A_j @ inv_A_t2cano_j
__device__ void joint_transform(const float* rw, const float* tw,
                                const float* jp, const float* inv,
                                float* out) {
  for (int r = 0; r < 3; ++r) {
    const float* w = rw + r * 3;
    const float at = tw[r] - dot4(w[0], jp[0], w[1], jp[1], w[2], jp[2],
                                  tw[r], 0.0f);
    for (int c = 0; c < 4; ++c)
      out[r * 4 + c] = dot4(w[0], inv[c], w[1], inv[4 + c], w[2], inv[8 + c],
                            at, inv[12 + c]);
  }
}

__global__ void __launch_bounds__(kMaxJoints)
pose_skeleton_fwd_kernel(const PoseArgs a) {
  __shared__ float s_jp[kMaxJoints][3], s_rot[kMaxJoints][9];
  __shared__ float s_rw[kMaxJoints][9], s_tw[kMaxJoints][3];
  const int b = blockIdx.x, j = threadIdx.x, nj = static_cast<int>(a.j);
  if (j < nj) {
    joint_position(a, j, s_jp[j]);
    joint_rotation(a, b, j, s_rot[j]);
  }
  if (j == 0) {
    // the frame's terms; 1 and the identity where none is given
    float* f = a.frame + b * kFrame;
    for (int c = 0; c < kFrame; ++c) f[c] = 0.0f;
    for (int c = 0; c < 3; ++c) f[kTransl + c] = a.transl[b * 3 + c];
    f[kScale] = a.scaled ? a.sscale[b] : 1.0f;
    f[kEscale] = 1.0f;
    f[kErot] = f[kErot + 4] = f[kErot + 8] = 1.0f;
    f[kQe] = 1.0f;
    if (a.ext) {
      for (int c = 0; c < 3; ++c) f[kEtrans + c] = a.etrans[b * 3 + c];
      f[kEscale] = a.escale[b];
      for (int c = 0; c < 9; ++c) f[kErot + c] = a.erot[b * 9 + c];
      mat_to_quat(f + kErot, f + kQe);
    }
  }
  __syncthreads();
  if (j == 0) chain_forward(a.parents, nj, s_jp, s_rot, s_rw, s_tw);
  __syncthreads();
  if (j < nj)
    joint_transform(s_rw[j], s_tw[j], s_jp[j], a.inv + j * 16,
                    a.a + (b * nj + j) * kRow);
}

__global__ void __launch_bounds__(kSkelBwdThreads)
pose_skeleton_bwd_kernel(const PoseArgs a) {
  // the gradients in double: the reduction's rows, the chain in reverse
  // and the pose rows' adjoints (the root's rotation gathers every joint's
  // terms, which cancel); the forward's values in float
  __shared__ float s_jp[kMaxJoints][3], s_rot[kMaxJoints][9];
  __shared__ float s_rw[kMaxJoints][9], s_tw[kMaxJoints][3];
  __shared__ double s_gjp[kMaxJoints][3], s_ga[kMaxJoints * kRow];
  __shared__ double s_grw[kMaxJoints][9], s_gtw[kMaxJoints][3];
  __shared__ double s_grot[kMaxJoints][9];
  __shared__ float s_ex[kExtra];
  const int t = threadIdx.x, nj = static_cast<int>(a.j);
  const int np = nj * kRow + kExtra, nb = static_cast<int>(a.b);
  const int ctas = static_cast<int>(a.ctas);
  if (t < nj) {
    joint_position(a, t, s_jp[t]);
    for (int c = 0; c < 3; ++c) s_gjp[t][c] = 0.0;
  }
  for (int b = 0; b < nb; ++b) {
    __syncthreads();
    // the skinning's per-CTA sums of this frame
    for (int o = t; o < np; o += blockDim.x) {
      double s = 0.0;
      for (int c = 0; c < ctas; ++c)
        s += a.partial[(static_cast<long long>(c) * nb + b) * np + o];
      if (o < nj * kRow)
        s_ga[o] = s;
      else
        s_ex[o - nj * kRow] = static_cast<float>(s);
    }
    if (t < nj) joint_rotation(a, b, t, s_rot[t]);
    __syncthreads();
    if (t == 0) chain_forward(a.parents, nj, s_jp, s_rot, s_rw, s_tw);
    __syncthreads();
    if (t < nj) {
      // A' = A inv: gA = gA' inv^T; A = [Rw | tw - Rw J]
      const float* inv = a.inv + t * 16;
      const double* g = s_ga + t * kRow;
      double ga[12];
      for (int r = 0; r < 3; ++r)
        for (int k = 0; k < 4; ++k)
          ga[r * 4 + k] = ((g[r * 4] * inv[k * 4] + g[r * 4 + 1] * inv[k * 4 + 1])
                           + g[r * 4 + 2] * inv[k * 4 + 2])
                          + g[r * 4 + 3] * inv[k * 4 + 3];
      for (int r = 0; r < 3; ++r) {
        for (int c = 0; c < 3; ++c)
          s_grw[t][r * 3 + c] = ga[r * 4 + c] - ga[r * 4 + 3] * s_jp[t][c];
        s_gtw[t][r] = ga[r * 4 + 3];
      }
      for (int c = 0; c < 3; ++c)
        s_gjp[t][c] -= (s_rw[t][c] * ga[3] + s_rw[t][3 + c] * ga[7])
                       + s_rw[t][6 + c] * ga[11];
    }
    __syncthreads();
    if (t == 0) {
      // the chain in reverse: parents[j] < j
      for (int j = nj - 1; j >= 1; --j) {
        const int p = a.parents[j];
        const float* w = s_rw[p];
        const double rel[3] = {s_jp[j][0] - s_jp[p][0], s_jp[j][1] - s_jp[p][1],
                               s_jp[j][2] - s_jp[p][2]};
        for (int k = 0; k < 3; ++k) {
          for (int c = 0; c < 3; ++c)
            s_grot[j][k * 3 + c] = (w[k] * s_grw[j][c] + w[3 + k] * s_grw[j][3 + c])
                                   + w[6 + k] * s_grw[j][6 + c];
          const double grel = (w[k] * s_gtw[j][0] + w[3 + k] * s_gtw[j][1])
                              + w[6 + k] * s_gtw[j][2];
          s_gjp[j][k] += grel;
          s_gjp[p][k] -= grel;
        }
        for (int r = 0; r < 3; ++r) {
          for (int k = 0; k < 3; ++k)
            s_grw[p][r * 3 + k] += ((s_grw[j][r * 3] * s_rot[j][k * 3]
                                     + s_grw[j][r * 3 + 1] * s_rot[j][k * 3 + 1])
                                    + s_grw[j][r * 3 + 2] * s_rot[j][k * 3 + 2])
                                   + s_gtw[j][r] * rel[k];
          s_gtw[p][r] += s_gtw[j][r];
        }
      }
      for (int c = 0; c < 9; ++c) s_grot[0][c] = s_grw[0][c];
      for (int c = 0; c < 3; ++c) s_gjp[0][c] += s_gtw[0][c];
    }
    __syncthreads();
    if (t < nj && t <= a.nbj) {
      // the pose row's gradient, at the row's place in go or bp
      const float* row = pose_row(a, b, t);
      float* grad = t == 0 ? a.d_go : a.d_bp;
      if (grad) {
        float* out = grad + (row - (t == 0 ? a.go : a.bp));
        double gd[3];
        aa_to_mat_bwd(row, s_grot[t], gd);
        for (int c = 0; c < 3; ++c) out[c] = static_cast<float>(gd[c]);
      }
    }
    if (a.d_bp) {
      // the body pose's entries past the rows read
      const int used = static_cast<int>(a.nbj) * 3;
      for (int i = used + t; i < a.bp_len; i += blockDim.x)
        a.d_bp[b * a.bp_len + i] = 0.0f;
    }
    if (t == static_cast<int>(blockDim.x) - 1) {
      if (a.d_transl)
        for (int c = 0; c < 3; ++c) a.d_transl[b * 3 + c] = s_ex[kTransl + c];
      if (a.d_sscale) a.d_sscale[b] = s_ex[kScale];
      if (a.ext) {
        if (a.d_etrans)
          for (int c = 0; c < 3; ++c) a.d_etrans[b * 3 + c] = s_ex[kEtrans + c];
        if (a.d_escale) a.d_escale[b] = s_ex[kEscale];
        if (a.d_erot) {
          float gm[9];
          for (int c = 0; c < 9; ++c) gm[c] = s_ex[kErot + c];
          mat_to_quat_bwd(a.erot + b * 9, s_ex + kQe, gm);
          for (int c = 0; c < 9; ++c) a.d_erot[b * 9 + c] = gm[c];
        }
      }
    }
  }
  __syncthreads();
  if (a.d_joints && t < nj)
    for (int c = 0; c < 3; ++c)
      a.d_joints[t * 3 + c] = static_cast<float>(s_gjp[t][c]);
}

// ---------------------------------------------------------------------------
// the skinning

struct Flags {
  bool scale, ext, rot;  // smpl_scale, ext_tfs, rotmat given
};

// the skinning kernels' shared memory, in floats: the staged frames'
// transforms and terms, a tile's weight rows (stride nj + 1), the
// backward's gradient rows and sums, then the ints (each joint's flag and
// the list of the joints a tile moves, its length last)
struct SkinSmem {
  int sa, sf, sw, sg, acc, ints, bytes;
};

__host__ __device__ inline SkinSmem skin_smem(int nj, int frames, int threads,
                                              bool bwd) {
  SkinSmem s;
  int o = 0;
  s.sa = o; o += frames * nj * kRow;
  s.sf = o; o += frames * kFrame;
  s.sw = o; o += threads * (nj + 1);
  s.sg = o; o += bwd ? threads * kGrow : 0;
  s.acc = o; o += bwd ? frames * (nj * kRow + kExtra) : 0;
  s.ints = o; o += 2 * kMaxJoints + 1;
  s.bytes = o * static_cast<int>(sizeof(float));
  return s;
}

// frames g0 .. g0 + nf - 1: their transforms and terms
__device__ void stage_frames(const PoseArgs& a, long long g0, int nf,
                             float* sa, float* sf) {
  const int nj = static_cast<int>(a.j);
  const float* ta = a.a + g0 * nj * kRow;
  const float* tf = a.frame + g0 * kFrame;
  for (int i = threadIdx.x; i < nf * nj * kRow; i += blockDim.x) sa[i] = ta[i];
  for (int i = threadIdx.x; i < nf * kFrame; i += blockDim.x) sf[i] = tf[i];
}

// a tile's weight rows by coalesced loads, and the joints some row moves
__device__ void stage_weights(const PoseArgs& a, long long n0, int rows,
                              float* sw, int* flag, int* act) {
  const int nj = static_cast<int>(a.j), t = threadIdx.x;
  __syncthreads();  // the last tile's reads are done
  if (t < nj) flag[t] = 0;
  __syncthreads();
  const float* src = a.w + n0 * nj;
  for (int i = t; i < rows * nj; i += blockDim.x) {
    const int r = i / nj, c = i - r * nj;
    const float v = src[i];
    sw[r * (nj + 1) + c] = v;
    if (v != 0.0f) flag[c] = 1;
  }
  __syncthreads();
  if (t == 0) {
    int m = 0;
    for (int j = 0; j < nj; ++j)
      if (flag[j]) act[m++] = j;
    act[kMaxJoints] = m;
  }
  __syncthreads();
}

// T = sum_j w_j A'_j over the joints the tile moves (rows 0-2)
__device__ void blend(const float* wrow, const float* fa, const int* act,
                      float* tr) {
  for (int e = 0; e < kRow; ++e) tr[e] = 0.0f;
  const int m = act[kMaxJoints];
  for (int i = 0; i < m; ++i) {
    const int j = act[i];
    const float wj = wrow[j];
    const float* aj = fa + j * kRow;
    for (int e = 0; e < kRow; ++e) tr[e] = fmaf(wj, aj[e], tr[e]);
  }
}

// the posed rotation T[:3, :3] @ rotmat_canon
__device__ void posed_rotation(const Flags& fl, const float* tr,
                               const float* rc, float* m) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      m[r * 3 + c] = fl.rot ? fmaf(tr[r * 4 + 2], rc[6 + c],
                                   fmaf(tr[r * 4 + 1], rc[3 + c],
                                        tr[r * 4] * rc[c]))
                            : tr[r * 4 + c];
}

// one gaussian in one frame: its centre (smpl_scale, transl, ext_tfs), its
// quaternion and its scales
__device__ void pose_one(const Flags& fl, const float* f, const float* tr,
                         const float* x, const float* sc, const float* rc,
                         float* p, float* q, float* so) {
  for (int r = 0; r < 3; ++r)
    p[r] = (fmaf(tr[r * 4 + 1], x[1], tr[r * 4] * x[0]) + tr[r * 4 + 2] * x[2])
           + tr[r * 4 + 3];
  for (int c = 0; c < 3; ++c) {
    so[c] = fl.scale ? sc[c] * f[kScale] : sc[c];
    p[c] = (fl.scale ? p[c] * f[kScale] : p[c]) + f[kTransl + c];
  }
  if (fl.ext) {
    const float* er = f + kErot;
    const float p2[3] = {p[0], p[1], p[2]};
    for (int r = 0; r < 3; ++r)
      p[r] = f[kEtrans + r]
             + f[kEscale] * ((er[r * 3] * p2[0] + er[r * 3 + 1] * p2[1])
                             + er[r * 3 + 2] * p2[2]);
    for (int c = 0; c < 3; ++c) so[c] = f[kEscale] * so[c];
  }
  float m[9];
  posed_rotation(fl, tr, rc, m);
  mat_to_quat(m, q);
  if (fl.ext) {
    // quaternion_multiply(qe, q): standardised
    float r4[4];
    quat_mul(f + kQe, q, r4);
    for (int i = 0; i < 4; ++i) q[i] = r4[0] < 0.0f ? -r4[i] : r4[i];
  }
}

// pose_one's backward from the cotangents gp, gq, gs: the gradient of the
// blended transform gt (12), the frame terms' ex (kExtra), and the
// gaussian's gx, gsc, grc accumulated
__device__ void pose_one_bwd(const Flags& fl, const float* f, const float* tr,
                             const float* x, const float* sc, const float* rc,
                             const float* gp, const float* gq, const float* gs,
                             float* gt, float* ex, float* gx, float* gsc,
                             float* grc) {
  const float s = f[kScale];
  float p0[3], p2[3], sc1[3];
  for (int r = 0; r < 3; ++r)
    p0[r] = ((tr[r * 4] * x[0] + tr[r * 4 + 1] * x[1]) + tr[r * 4 + 2] * x[2])
            + tr[r * 4 + 3];
  for (int c = 0; c < 3; ++c) {
    p2[c] = (fl.scale ? p0[c] * s : p0[c]) + f[kTransl + c];
    sc1[c] = fl.scale ? sc[c] * s : sc[c];
  }
  float m[9];
  posed_rotation(fl, tr, rc, m);
  for (int k = 0; k < kExtra; ++k) ex[k] = 0.0f;
  float gp2[3], gsc1[3], gqm[4];
  if (fl.ext) {
    const float* er = f + kErot;
    const float e = f[kEscale];
    // p3 = etrans + e (erot p2), so = e sc1
    for (int r = 0; r < 3; ++r) {
      const float rp = (er[r * 3] * p2[0] + er[r * 3 + 1] * p2[1])
                       + er[r * 3 + 2] * p2[2];
      ex[kEtrans + r] = gp[r];
      ex[kEscale] += gp[r] * rp + gs[r] * sc1[r];
      for (int c = 0; c < 3; ++c) ex[kErot + r * 3 + c] = e * gp[r] * p2[c];
    }
    for (int c = 0; c < 3; ++c) {
      gp2[c] = e * ((er[c] * gp[0] + er[3 + c] * gp[1]) + er[6 + c] * gp[2]);
      gsc1[c] = e * gs[c];
    }
    // q_out = standardize(qe * q)
    const float* qe = f + kQe;
    float q[4], r4[4];
    mat_to_quat(m, q);
    quat_mul(qe, q, r4);
    float g[4];
    for (int i = 0; i < 4; ++i) g[i] = r4[0] < 0.0f ? -gq[i] : gq[i];
    ex[kQe] = ((g[0] * q[0] + g[1] * q[1]) + g[2] * q[2]) + g[3] * q[3];
    ex[kQe + 1] = ((-g[0] * q[1] + g[1] * q[0]) - g[2] * q[3]) + g[3] * q[2];
    ex[kQe + 2] = ((-g[0] * q[2] + g[1] * q[3]) + g[2] * q[0]) - g[3] * q[1];
    ex[kQe + 3] = ((-g[0] * q[3] - g[1] * q[2]) + g[2] * q[1]) + g[3] * q[0];
    gqm[0] = ((qe[0] * g[0] + qe[1] * g[1]) + qe[2] * g[2]) + qe[3] * g[3];
    gqm[1] = ((-qe[1] * g[0] + qe[0] * g[1]) + qe[3] * g[2]) - qe[2] * g[3];
    gqm[2] = ((-qe[2] * g[0] - qe[3] * g[1]) + qe[0] * g[2]) + qe[1] * g[3];
    gqm[3] = ((-qe[3] * g[0] + qe[2] * g[1]) - qe[1] * g[2]) + qe[0] * g[3];
  } else {
    for (int c = 0; c < 3; ++c) {
      gp2[c] = gp[c];
      gsc1[c] = gs[c];
    }
    for (int i = 0; i < 4; ++i) gqm[i] = gq[i];
  }
  // p2 = p0 s + transl, sc1 = sc s
  float gp0[3];
  for (int c = 0; c < 3; ++c) {
    ex[kTransl + c] = gp2[c];
    gp0[c] = fl.scale ? gp2[c] * s : gp2[c];
    gsc[c] += fl.scale ? gsc1[c] * s : gsc1[c];
  }
  if (fl.scale)
    ex[kScale] = ((gp2[0] * p0[0] + gp2[1] * p0[1]) + gp2[2] * p0[2])
                 + ((gsc1[0] * sc[0] + gsc1[1] * sc[1]) + gsc1[2] * sc[2]);
  // p0 = T[:3, :3] x + T[:3, 3]
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) gt[r * 4 + c] = gp0[r] * x[c];
    gt[r * 4 + 3] = gp0[r];
  }
  for (int c = 0; c < 3; ++c)
    gx[c] += (tr[c] * gp0[0] + tr[4 + c] * gp0[1]) + tr[8 + c] * gp0[2];
  // the quaternion of m = T[:3, :3] rotmat_canon
  float gm[9];
  for (int i = 0; i < 9; ++i) gm[i] = 0.0f;
  mat_to_quat_bwd(m, gqm, gm);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      gt[r * 4 + c] += fl.rot ? (gm[r * 3] * rc[c * 3] + gm[r * 3 + 1] * rc[c * 3 + 1])
                                    + gm[r * 3 + 2] * rc[c * 3 + 2]
                              : gm[r * 3 + c];
  if (fl.rot)
    for (int k = 0; k < 3; ++k)
      for (int c = 0; c < 3; ++c)
        grc[k * 3 + c] += (tr[k] * gm[c] + tr[4 + k] * gm[3 + c])
                          + tr[8 + k] * gm[6 + c];
}

__global__ void __launch_bounds__(kFwdThreads)
pose_skin_fwd_kernel(const PoseArgs a) {
  extern __shared__ float smem[];
  const int nj = static_cast<int>(a.j), t = threadIdx.x;
  const int frames = a.b < kMaxFrames ? static_cast<int>(a.b) : kMaxFrames;
  const SkinSmem lay = skin_smem(nj, frames, kFwdThreads, false);
  float* sa = smem + lay.sa;
  float* sf = smem + lay.sf;
  float* sw = smem + lay.sw;
  int* flag = reinterpret_cast<int*>(smem + lay.ints);
  int* act = flag + kMaxJoints;
  const Flags fl{a.scaled != 0, a.ext != 0, a.rotmat != nullptr};
  const long long ntiles = (a.n + kFwdThreads - 1) / kFwdThreads;
  for (long long g0 = 0; g0 < a.b; g0 += kMaxFrames) {
    const int nf = a.b - g0 < kMaxFrames ? static_cast<int>(a.b - g0)
                                         : kMaxFrames;
    __syncthreads();  // the last group's reads are done
    stage_frames(a, g0, nf, sa, sf);
    for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const long long n0 = tile * kFwdThreads;
      const int rows = a.n - n0 < kFwdThreads ? static_cast<int>(a.n - n0)
                                              : kFwdThreads;
      stage_weights(a, n0, rows, sw, flag, act);
      if (t >= rows) continue;
      const long long n = n0 + t;
      float x[3], sc[3], rc[9];
      for (int c = 0; c < 3; ++c) {
        x[c] = a.xyz[n * 3 + c];
        sc[c] = a.scales[n * 3 + c];
      }
      if (fl.rot)
        for (int c = 0; c < 9; ++c) rc[c] = a.rotmat[n * 9 + c];
      for (int b = 0; b < nf; ++b) {
        float tr[kRow], p[3], q[4], so[3];
        blend(sw + t * (nj + 1), sa + b * nj * kRow, act, tr);
        pose_one(fl, sf + b * kFrame, tr, x, sc, rc, p, q, so);
        const long long o = (g0 + b) * a.n + n;
        for (int c = 0; c < 3; ++c) {
          a.out_xyz[o * 3 + c] = p[c];
          a.out_scales[o * 3 + c] = so[c];
        }
        for (int c = 0; c < 4; ++c) a.out_rotq[o * 4 + c] = q[c];
      }
    }
  }
}

__global__ void __launch_bounds__(kBwdThreads)
pose_skin_bwd_kernel(const PoseArgs a) {
  extern __shared__ float smem[];
  const int nj = static_cast<int>(a.j), t = threadIdx.x;
  const int np = nj * kRow + kExtra;
  const int frames = a.b < kMaxFrames ? static_cast<int>(a.b) : kMaxFrames;
  const SkinSmem lay = skin_smem(nj, frames, kBwdThreads, true);
  float* sa = smem + lay.sa;
  float* sf = smem + lay.sf;
  float* sw = smem + lay.sw;
  float* sg = smem + lay.sg;
  float* acc = smem + lay.acc;
  int* flag = reinterpret_cast<int*>(smem + lay.ints);
  int* act = flag + kMaxJoints;
  const Flags fl{a.scaled != 0, a.ext != 0, a.rotmat != nullptr};
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const long long ntiles = (a.n + kBwdThreads - 1) / kBwdThreads;
  for (long long g0 = 0; g0 < a.b; g0 += kMaxFrames) {
    const int nf = a.b - g0 < kMaxFrames ? static_cast<int>(a.b - g0)
                                         : kMaxFrames;
    __syncthreads();  // the last group's reads are done
    stage_frames(a, g0, nf, sa, sf);
    for (int o = t; o < nf * np; o += blockDim.x) acc[o] = 0.0f;
    for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const long long n0 = tile * kBwdThreads;
      const int rows = a.n - n0 < kBwdThreads ? static_cast<int>(a.n - n0)
                                              : kBwdThreads;
      stage_weights(a, n0, rows, sw, flag, act);
      const bool live = t < rows;
      const long long n = n0 + t;
      float x[3], sc[3], rc[9], gx[3], gsc[3], grc[9];
      for (int c = 0; c < 3; ++c) gx[c] = gsc[c] = 0.0f;
      for (int c = 0; c < 9; ++c) grc[c] = 0.0f;
      if (live) {
        for (int c = 0; c < 3; ++c) {
          x[c] = a.xyz[n * 3 + c];
          sc[c] = a.scales[n * 3 + c];
        }
        if (fl.rot)
          for (int c = 0; c < 9; ++c) rc[c] = a.rotmat[n * 9 + c];
        if (g0 > 0) {
          // the earlier groups' sums, this thread's own
          for (int c = 0; c < 3; ++c) {
            if (a.d_xyz) gx[c] = a.d_xyz[n * 3 + c];
            if (a.d_scales) gsc[c] = a.d_scales[n * 3 + c];
          }
          if (fl.rot && a.d_rotmat)
            for (int c = 0; c < 9; ++c) grc[c] = a.d_rotmat[n * 9 + c];
        }
      }
      float* row = sg + t * kGrow;
      for (int b = 0; b < nf; ++b) {
        if (live) {
          float tr[kRow];
          blend(sw + t * (nj + 1), sa + b * nj * kRow, act, tr);
          const long long o = (g0 + b) * a.n + n;
          pose_one_bwd(fl, sf + b * kFrame, tr, x, sc, rc,
                       a.g_xyz ? a.g_xyz + o * 3 : zero,
                       a.g_rotq ? a.g_rotq + o * 4 : zero,
                       a.g_scales ? a.g_scales + o * 3 : zero, row,
                       row + kRow, gx, gsc, grc);
        } else {
          for (int k = 0; k < kGrow; ++k) row[k] = 0.0f;
        }
        __syncthreads();
        // the tile's sums: sum_r w_rj gT_re for the joints it moves, and
        // the frame terms
        float* ab = acc + b * np;
        for (int o = t; o < np; o += blockDim.x) {
          float s = 0.0f;
          if (o < nj * kRow) {
            const int j = o / kRow, e = o - j * kRow;
            if (flag[j])
              for (int r = 0; r < rows; ++r)
                s = fmaf(sw[r * (nj + 1) + j], sg[r * kGrow + e], s);
          } else {
            const int k = kRow + o - nj * kRow;
            for (int r = 0; r < rows; ++r) s += sg[r * kGrow + k];
          }
          ab[o] += s;
        }
        __syncthreads();
      }
      if (live) {
        for (int c = 0; c < 3; ++c) {
          if (a.d_xyz) a.d_xyz[n * 3 + c] = gx[c];
          if (a.d_scales) a.d_scales[n * 3 + c] = gsc[c];
        }
        if (fl.rot && a.d_rotmat)
          for (int c = 0; c < 9; ++c) a.d_rotmat[n * 9 + c] = grc[c];
      }
    }
    float* out = a.partial + (static_cast<long long>(blockIdx.x) * a.b + g0) * np;
    for (int o = t; o < nf * np; o += blockDim.x) out[o] = acc[o];
  }
}

bool skeleton_ok(const PoseArgs* a) {
  return a->b > 0 && a->j >= 1 && a->j <= kMaxJoints && a->nbj >= 0 &&
         a->nbj < a->j && a->go && a->bp && a->joints &&
         a->parents && a->inv && a->transl &&
         (a->rest || a->j == a->nbj + 1) &&
         a->bp_len >= a->nbj * 3 &&
         (!a->scaled || a->sscale) &&
         (!a->ext || (a->etrans && a->erot && a->escale));
}

bool skin_ok(const PoseArgs* a) {
  return a->b > 0 && a->j >= 1 && a->j <= kMaxJoints && a->n > 0 &&
         a->ctas > 0 && a->xyz && a->scales && a->w && a->a && a->frame;
}

}  // namespace

extern "C" int pose_skeleton_fwd(const PoseArgs* a, void* stream) {
  if (!skeleton_ok(a) || !a->a || !a->frame)
    return static_cast<int>(cudaErrorInvalidValue);
  pose_skeleton_fwd_kernel<<<static_cast<unsigned>(a->b), kMaxJoints, 0,
                             static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pose_skin_fwd(const PoseArgs* a, void* stream) {
  if (!skin_ok(a) || !a->out_xyz || !a->out_rotq || !a->out_scales)
    return static_cast<int>(cudaErrorInvalidValue);
  const int frames = a->b < kMaxFrames ? static_cast<int>(a->b) : kMaxFrames;
  const int bytes = skin_smem(static_cast<int>(a->j), frames, kFwdThreads,
                              false).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      pose_skin_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  pose_skin_fwd_kernel<<<static_cast<unsigned>(a->ctas), kFwdThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pose_skin_bwd(const PoseArgs* a, void* stream) {
  if (!skin_ok(a) || !a->partial) return static_cast<int>(cudaErrorInvalidValue);
  const int frames = a->b < kMaxFrames ? static_cast<int>(a->b) : kMaxFrames;
  const int bytes = skin_smem(static_cast<int>(a->j), frames, kBwdThreads,
                              true).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      pose_skin_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  pose_skin_bwd_kernel<<<static_cast<unsigned>(a->ctas), kBwdThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pose_skeleton_bwd(const PoseArgs* a, void* stream) {
  if (!skeleton_ok(a) || !a->partial || a->ctas <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  pose_skeleton_bwd_kernel<<<1, kSkelBwdThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
