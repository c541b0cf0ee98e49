// The backward of bilinear sampling and of the triplane, for Hopper
// (sm_90a): the grid gradients over the queries sorted by cell and the
// coordinate gradients over the queries in their own order, with no
// float atomics.
//
// Replaces the JAX package's custom backwards (XLA, no pallas_call):
// sings_tpu/fields/triplane.py::_triplane_nested_bwd (:378) and
// _triplane_fused_bwd (:179), sings_tpu/ops/sampling.py::_sample_bwd
// (:129): the product rule over each scale's Hadamard product, each
// plane's coordinate gradient through its weight path (jax.vjp there),
// and from lax.sort_key_val to the (C, H, W) grid gradients.
// sings_tpu_torch/ops/grid_grad.py::triplane_bwd_plain is the same
// function in PyTorch.
//
// Inputs: the coordinates q (N, qs), the cotangent gout (N, S*C), the
// planes (C, H, W), the forward's saved samples (N, C) of every plane
// (read for the product rule, not recomputed: a plane's cotangent row
// is gout[n, sC:(s+1)C] * sample_a[n] * sample_b[n], the scale's two
// other planes, in JAX's order), and each sort group's keys, as the
// forward made them and sorted with their order. A problem is one
// segment reduction over one group's sorted rows: row i is query j =
// order[i] of plane plane0 + j / N, its segment skey[i] >> shift2 (the
// nested triplane's level-l cell is the fine Morton code shifted right
// by 2 shift_l, so one sort serves every level), its cell cell_base +
// the key (row-major keys) or cell_base + y * cx + x with (x, y)
// de-interleaved from the key. Nothing saved in the forward holds
// corner rows or weights: tx, ty and the clip factors are recomputed
// from q (the forward's float32 operations, in its order, nvcc
// -fmad=false), the corner values read from the planes.
//
// After the sorts (torch.sort, glue), five launches, no float atomics,
// every sum in a fixed order, so two calls give the same bits:
//   a memset of the per-cell written flags.
//   triplane_bwd_segment_kernel: one warp per block of kRows sorted rows
//     of a problem, lanes on the channels (C <= 32). The warp stages the
//     block's segments, the rows' load offsets, tx, ty and scaled clip
//     factors in shared memory, then walks the rows in batches of
//     kUnroll, their cotangent and sample loads in flight together,
//     forming each row's plane cotangent g (never written) and
//       * the cell sums w_k(tx, ty) g in float64. A segment wholly inside
//         the block is rounded once and written to its cell's (4, C) row;
//         the block's first and last segment go to partial slots 2b and
//         2b + 1 (a block of one segment writes it to 2b, and zeros under
//         the same cell to 2b + 1);
//       * the weight path: the segment's four corner rows v_k, loaded
//         once a segment (the planes, 33.4 MB at full width, stay in the
//         50 MB L2), the batch's 4 kUnroll dot products dw_k = sum_c g v_k in one warp
//         reduce-scatter, then d/dx = ((dw1 - dw0)(1 - ty)
//         + (dw3 - dw2) ty) times the clip factor and d/dy likewise,
//         written to the (P, N, 2) terms.
//     A row whose g is exactly zero on every channel adds +-0 to every
//     sum and term, which changes no bit: its products and adds are
//     skipped (a fifth of the avatar's queries, the dead slots at xyz =
//     0, in one cell at every level).
//   triplane_bwd_partial_kernel: kPartWarps warps per CTA take one slot
//     each; a slot that starts a run of equal cells finds its end by
//     ballot. Its warp sums a run of up to kShortRun slots in slot order
//     and writes the cell's row; a longer run (the dead cell's 400 at
//     full width) is summed by all the CTA's warps in a fixed stride
//     (warp w the slots w, w + kPartWarps, ...), their sums added in
//     warp order.
//   triplane_bwd_unstack_kernel: one CTA per (plane, grid row y, 32 grid
//     columns). Corners 2 and 3 of the cells (y - 1, x0 - 1..x0 + 31) and
//     corners 0 and 1 of the cells (y, ...) go through shared memory, a
//     warp a cell (those no segment wrote read as zero, by the flag),
//     then each grid point adds corner 0 of cell (y, x), 1 of (y, x - 1),
//     2 of (y - 1, x), 3 of (y - 1, x - 1) in that order (JAX's four
//     slice-adds) and is written in (C, H, W) order.
//   triplane_bwd_dq_kernel: query-major, a thread a query: its planes'
//     terms added in plane order (dq[a] += d/dx, dq[b] += d/dy:
//     coord_grads' order).
//
// Bound on the H100: bytes. The function reads gout, q and the planes
// once and writes the plane gradients and dq once: at the nested 64^3
// triplane of 127,744 queries, C = 32 and multires [1, 2, 4], ~119 MB,
// 0.0355 ms at 3.35 TB/s. This design reads each (plane, query) pair's
// cotangent slice and two sample rows (384 B, 441 MB at that size) in
// sorted order, the keys and orders (12 B a row), q (in L2) and a
// segment's corner rows once; it writes the (4, C) rows of occupied
// cells, 2 partial slots of 4C doubles per block and 8 B of terms a
// row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;        // sorted rows per block
constexpr int kStage = kRows / 32;
constexpr int kWarps = 4;         // warps per CTA of the segment pass
constexpr int kUnroll = 4;        // rows a batch: their loads in flight
constexpr int kPartWarps = 8;     // warps per CTA of the partial pass
constexpr int kShortRun = 16;     // partial slots one warp sums alone
constexpr int kDqThreads = 256;
constexpr int kMaxProblems = 16;
constexpr int kMaxPlanes = 16;
constexpr int kMaxC = 32;
constexpr int kTileX = 32;        // grid columns per unstack CTA
constexpr int kTileThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Problem {
  const int* skey;
  const long long* order;
  long long rows;
  long long cell_base;
  long long block0;     // first global block of the problem
  int shift2;
  int plane0;
  int morton;
  int cx;
};

struct Plane {
  const float* grid;    // (C, H, W)
  float* out;           // its gradient, (C, H, W)
  const float* f1;      // the scale's other two samples (product rule)
  const float* f2;
  long long cell_base;
  long long tile0;      // first unstack CTA of the plane
  int h;
  int w;
  int a;                // q columns of x and y
  int b;
  int gcol;             // first column of gout
};

struct Params {
  Problem prob[kMaxProblems];
  Plane plane[kMaxPlanes];
  int n_problems;
  int n_planes;
  int c;
  int qs;               // q's row stride
  int gs;               // gout's row stride
  long long n;          // queries
  long long n_blocks;
  const float* q;
  const float* gout;
  float* dq;
  float* cellsum;       // (cells, 4c), rows of occupied cells written
  unsigned char* flag;  // (cells,), zeroed; 1 where a row was written
  double* part;         // (2 n_blocks, 4c)
  long long* part_cell; // (2 n_blocks,)
  float* dterm;         // (planes, n, 2) d/dx, d/dy of each row
};

__device__ __forceinline__ unsigned compact16(unsigned v) {
  v &= 0x55555555u;
  v = (v | (v >> 1)) & 0x33333333u;
  v = (v | (v >> 2)) & 0x0F0F0F0Fu;
  v = (v | (v >> 4)) & 0x00FF00FFu;
  v = (v | (v >> 8)) & 0x0000FFFFu;
  return v;
}

__device__ __forceinline__ long long cell_of(const Problem& p, int seg) {
  if (!p.morton) return p.cell_base + seg;
  const unsigned u = static_cast<unsigned>(seg);
  return p.cell_base + static_cast<long long>(compact16(u >> 1)) * p.cx +
         compact16(u);
}

// the plane whose unstack tiles hold tile t
__device__ __forceinline__ int plane_of_tile(const Params& P, long long t) {
  int pi = 0;
  while (pi + 1 < P.n_planes && P.plane[pi + 1].tile0 <= t) ++pi;
  return pi;
}

// one axis of the forward's _corner_coords and _coord_grad's factor, in
// torch's float32 operations: x = (q + 1) * 0.5 * (size - 1), clipped to
// [0, size - 1] (NaN stays NaN, as torch.clamp), base corner
// floor(x) clamped to [0, size - 2], t = x - x0; fs = jnp.clip's factor
// at x times 0.5 * (size - 1)
__device__ __forceinline__ void axis(float qv, int size, float& t,
                                     float& fs) {
  const float hi = static_cast<float>(size - 1);
  const float x = (qv + 1.0f) * 0.5f * hi;
  float xc = x < 0.0f ? 0.0f : x;
  xc = xc > hi ? hi : xc;
  const float top = static_cast<float>(size - 2);
  float x0 = floorf(xc);
  x0 = x0 < 0.0f ? 0.0f : x0;
  x0 = x0 > top ? top : x0;
  t = xc - x0;
  const float f_lo = x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f);
  const float y = x < 0.0f ? 0.0f : x;
  const float f_hi = y < hi ? 1.0f : (y == hi ? 0.5f : 0.0f);
  fs = (f_lo * f_hi) * (0.5f * hi);
}

// one step of warp_reduce_scatter over N values: at H >= N every value
// is added across the lanes that differ in bit H; below, lanes with bit
// H keep the upper H values and send the lower, the others the reverse
template <int N, int H>
__device__ __forceinline__ void reduce_step(float (&x)[N], int lane) {
  if constexpr (H >= N) {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] += __shfl_xor_sync(kFull, x[j], H);
  } else {
    const bool hi = lane & H;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float send = hi ? x[j] : x[j + H];
      const float keep = hi ? x[j + H] : x[j];
      x[j] = keep + __shfl_xor_sync(kFull, send, H);
    }
  }
}

// the sums over the warp's lanes of N <= 32 values at once (N a power of
// two, 31 shuffles at N = 32); lane L ends with the sum of x[L % N]
template <int N>
__device__ __forceinline__ float warp_reduce_scatter(float (&x)[N],
                                                     int lane) {
  reduce_step<N, 16>(x, lane);
  reduce_step<N, 8>(x, lane);
  reduce_step<N, 4>(x, lane);
  reduce_step<N, 2>(x, lane);
  reduce_step<N, 1>(x, lane);
  return x[0];
}

// channel `lane` of the four corner rows of the segment's cell
__device__ __forceinline__ void load_corners(const Params& P,
                                             const Problem& pr, int p,
                                             int seg, int lane, bool on,
                                             float (&v)[4]) {
  const Plane& pl = P.plane[p];
  long long x, y;
  if (pr.morton) {
    const unsigned u = static_cast<unsigned>(seg);
    x = compact16(u);
    y = compact16(u >> 1);
  } else {
    const long long local = pr.cell_base + seg - pl.cell_base;
    y = local / (pl.w - 1);
    x = local - y * (pl.w - 1);
  }
  const float* r = pl.grid + static_cast<long long>(lane) * pl.h * pl.w +
                   y * pl.w + x;
  v[0] = on ? __ldg(r) : 0.0f;
  v[1] = on ? __ldg(r + 1) : 0.0f;
  v[2] = on ? __ldg(r + pl.w) : 0.0f;
  v[3] = on ? __ldg(r + pl.w + 1) : 0.0f;
}

// the (4, c) sums a0..a3 of channel ch of a segment: into its cell's row
// (rounded once) or into a partial slot (float64)
__device__ __forceinline__ void write_cell(const Params& P, long long cell,
                                           int ch, bool on, int lane,
                                           const double (&a)[4]) {
  if (on) {
    float* row = P.cellsum + cell * 4 * P.c;
#pragma unroll
    for (int k = 0; k < 4; ++k) row[k * P.c + ch] = static_cast<float>(a[k]);
  }
  if (lane == 0) P.flag[cell] = 1;
}

__device__ __forceinline__ void write_part(const Params& P, long long slot,
                                           long long cell, int ch, bool on,
                                           int lane, const double (&a)[4]) {
  if (on) {
    double* row = P.part + slot * 4 * P.c;
#pragma unroll
    for (int k = 0; k < 4; ++k) row[k * P.c + ch] = a[k];
  }
  if (lane == 0) P.part_cell[slot] = cell;
}

template <bool kProduct>
__global__ void __launch_bounds__(32 * kWarps)
    triplane_bwd_segment_kernel(const __grid_constant__ Params P) {
  __shared__ int s_seg[kWarps][kRows];
  __shared__ int s_go[kWarps][kRows];   // the row's cotangent slice
  __shared__ int s_so[kWarps][kRows];   // its samples' row
  __shared__ int s_dt[kWarps][kRows];   // its (plane, query) term
  __shared__ unsigned char s_p[kWarps][kRows];
  __shared__ float s_tx[kWarps][kRows];
  __shared__ float s_ty[kWarps][kRows];
  __shared__ float s_fx[kWarps][kRows];
  __shared__ float s_fy[kWarps][kRows];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long blk = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (blk >= P.n_blocks) return;
  int pi = 0;
  while (pi + 1 < P.n_problems && P.prob[pi + 1].block0 <= blk) ++pi;
  const Problem& pr = P.prob[pi];
  const long long r0 = (blk - pr.block0) * kRows;
  const int nr = static_cast<int>(min(static_cast<long long>(kRows),
                                      pr.rows - r0));

  // stage the block: orders and keys, then q, then each row's axes
  long long jj[kStage];
  int kk[kStage];
#pragma unroll
  for (int u = 0; u < kStage; ++u) {
    const int i = lane + 32 * u;
    jj[u] = 0;
    kk[u] = 0;
    if (i < nr) {
      jj[u] = pr.order[r0 + i];
      kk[u] = pr.skey[r0 + i];
    }
  }
  float qa[kStage], qb[kStage];
  int pp[kStage], nn[kStage];
#pragma unroll
  for (int u = 0; u < kStage; ++u) {
    const int i = lane + 32 * u;
    const long long off = pr.morton ? 0 : jj[u] / P.n;
    pp[u] = pr.plane0 + static_cast<int>(off);
    nn[u] = static_cast<int>(jj[u] - off * P.n);
    qa[u] = 0.0f;
    qb[u] = 0.0f;
    if (i < nr) {
      const Plane& pl = P.plane[pp[u]];
      qa[u] = __ldg(P.q + static_cast<long long>(nn[u]) * P.qs + pl.a);
      qb[u] = __ldg(P.q + static_cast<long long>(nn[u]) * P.qs + pl.b);
    }
  }
#pragma unroll
  for (int u = 0; u < kStage; ++u) {
    const int i = lane + 32 * u;
    if (i < nr) {
      const Plane& pl = P.plane[pp[u]];
      float tx, ty, fx, fy;
      axis(qa[u], pl.w, tx, fx);
      axis(qb[u], pl.h, ty, fy);
      s_seg[warp][i] = kk[u] >> pr.shift2;
      s_go[warp][i] = nn[u] * P.gs + pl.gcol;
      s_so[warp][i] = nn[u] * P.c;
      s_dt[warp][i] = pp[u] * static_cast<int>(P.n) + nn[u];
      s_p[warp][i] = static_cast<unsigned char>(pp[u]);
      s_tx[warp][i] = tx;
      s_ty[warp][i] = ty;
      s_fx[warp][i] = fx;
      s_fy[warp][i] = fy;
    }
  }
  __syncwarp();

  const bool on = lane < P.c;
  const long long slot0 = 2 * blk;
  double a[4] = {0.0, 0.0, 0.0, 0.0};
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  bool have_v = false;  // v holds the current segment's corners
  int cur = s_seg[warp][0];
  int runs = 0;  // segments of this block finished so far
  for (int i0 = 0; i0 < nr; i0 += kUnroll) {
    // each row's cotangent slice and the scale's two other samples
    float g[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u;
      g[u] = 0.0f;
      if (on && i < nr) {
        g[u] = __ldg(P.gout + s_go[warp][i] + lane);
        if (kProduct) {
          const Plane& pl = P.plane[s_p[warp][i]];
          g[u] = (g[u] * __ldg(pl.f1 + s_so[warp][i] + lane)) *
                 __ldg(pl.f2 + s_so[warp][i] + lane);
        }
      }
    }
    // the rows in order: segment ends, the cell sums, and each row's
    // products g v_k with its segment's corners (x[4u + k])
    float x[4 * kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u;
#pragma unroll
      for (int k = 0; k < 4; ++k) x[4 * u + k] = 0.0f;
      if (i >= nr) continue;
      const int seg = s_seg[warp][i];
      if (seg != cur) {
        const long long cell = cell_of(pr, cur);
        if (runs == 0) {
          write_part(P, slot0, cell, lane, on, lane, a);
        } else {
          write_cell(P, cell, lane, on, lane, a);
        }
        ++runs;
        cur = seg;
        have_v = false;
#pragma unroll
        for (int k = 0; k < 4; ++k) a[k] = 0.0;
      }
      if (__any_sync(kFull, g[u] != 0.0f)) {
        const float tx = s_tx[warp][i];
        const float ty = s_ty[warp][i];
        const float ux = 1.0f - tx;
        const float uy = 1.0f - ty;
        const float w[4] = {ux * uy, tx * uy, ux * ty, tx * ty};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          a[k] += static_cast<double>(w[k] * g[u]);
        if (!have_v) {
          load_corners(P, pr, s_p[warp][i], cur, lane, on, v);
          have_v = true;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) x[4 * u + k] = g[u] * v[k];
      }
    }
    // dw_k of row u on lanes 4u + k (mod 4 kUnroll), gathered on each
    constexpr int kN = 4 * kUnroll;
    const float own = warp_reduce_scatter<kN>(x, lane);
    const int slot = lane & (kN - 1) & ~3;
    float dw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) dw[k] = __shfl_sync(kFull, own, slot + k);
    const int i = i0 + slot / 4;
    if (lane < kN && (lane & 3) == 0 && i < nr) {
      const float tx = s_tx[warp][i];
      const float ty = s_ty[warp][i];
      const float d_tx = (dw[1] - dw[0]) * (1.0f - ty) + (dw[3] - dw[2]) * ty;
      const float d_ty = (dw[2] - dw[0]) * (1.0f - tx) + (dw[3] - dw[1]) * tx;
      reinterpret_cast<float2*>(P.dterm)[s_dt[warp][i]] =
          make_float2(d_tx * s_fx[warp][i], d_ty * s_fy[warp][i]);
    }
  }
  const long long cell = cell_of(pr, cur);
  if (runs == 0) {
    write_part(P, slot0, cell, lane, on, lane, a);
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = 0.0;
  }
  write_part(P, slot0 + 1, cell, lane, on, lane, a);
}

// a run of partial slots of one cell summed by one warp, slot by slot:
// lanes on the channels
__device__ __forceinline__ void sum_slots(const Params& P, long long st,
                                          long long en, long long step,
                                          int lane, double (&acc)[4]) {
  const int c = P.c;
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = 0.0;
  if (lane >= c) return;
#pragma unroll 4
  for (long long s = st; s < en; s += step) {
    const double* row = P.part + s * 4 * c;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] += row[k * c + lane];
  }
}

__global__ void __launch_bounds__(32 * kPartWarps)
    triplane_bwd_partial_kernel(const __grid_constant__ Params P) {
  __shared__ long long s_start[kPartWarps];
  __shared__ long long s_end[kPartWarps];
  __shared__ double s_sum[kPartWarps][4][kMaxC];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_slots = 2 * P.n_blocks;
  const long long slot =
      static_cast<long long>(blockIdx.x) * kPartWarps + warp;
  long long start = -1, end = 0;
  if (slot < n_slots) {
    const long long cell = P.part_cell[slot];
    if (slot == 0 || P.part_cell[slot - 1] != cell) {
      // the run's end: 32 slots compared per step, the first mismatch by
      // ballot
      start = slot;
      end = slot + 1;
      for (;;) {
        const long long s = end + lane;
        const bool same = s < n_slots && P.part_cell[s] == cell;
        const unsigned m = __ballot_sync(kFull, same);
        if (m != kFull) {
          end += __ffs(~m) - 1;
          break;
        }
        end += 32;
      }
    }
  }
  const bool on = lane < P.c;
  // a short run: its warp alone
  if (start >= 0 && end - start <= kShortRun) {
    double acc[4];
    sum_slots(P, start, end, 1, lane, acc);
    write_cell(P, P.part_cell[start], lane, on, lane, acc);
    start = -1;
  }
  if (lane == 0) {
    s_start[warp] = start;
    s_end[warp] = end;
  }
  __syncthreads();
  // a long run (the dead cell's): every warp of the CTA a stride of its
  // slots, the warps' sums added in warp order
  for (int r = 0; r < kPartWarps; ++r) {
    const long long st = s_start[r];
    if (st < 0) continue;  // the same for the whole CTA
    double acc[4];
    sum_slots(P, st + warp, s_end[r], kPartWarps, lane, acc);
#pragma unroll
    for (int k = 0; k < 4; ++k) s_sum[warp][k][lane] = acc[k];
    __syncthreads();
    if (warp == 0) {
      double tot[4] = {0.0, 0.0, 0.0, 0.0};
      for (int w = 0; w < kPartWarps; ++w) {
#pragma unroll
        for (int k = 0; k < 4; ++k) tot[k] += s_sum[w][k][lane];
      }
      write_cell(P, P.part_cell[st], lane, on, lane, tot);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kTileThreads)
    triplane_bwd_unstack_kernel(const __grid_constant__ Params P) {
  // [row r][cell j][2 corners][channel], r = 0 the cells y - 1 (their
  // corners 2, 3), r = 1 the cells y (corners 0, 1); odd stride per cell
  constexpr int kStride = 2 * kMaxC + 1;
  __shared__ float sm[2][kTileX + 1][kStride];
  const long long t = blockIdx.x;
  const Plane& pl = P.plane[plane_of_tile(P, t)];
  const int tiles_x = (pl.w + kTileX - 1) / kTileX;
  const long long lt = t - pl.tile0;
  const int y = static_cast<int>(lt / tiles_x);
  const int x0 = static_cast<int>(lt - static_cast<long long>(y) * tiles_x) *
                 kTileX;
  const int cy = pl.h - 1;
  const int cx = pl.w - 1;
  const int c = P.c;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // a warp a cell (e = r (kTileX + 1) + j, cell (y - 1 + r, x0 - 1 + j)),
  // lanes on the channels: every flag of the warp's cells, then every
  // row, in flight together; unwritten and outside cells read zero
  constexpr int kCells = 2 * (kTileX + 1);
  constexpr int kWarpsU = kTileThreads / 32;
  constexpr int kPerWarp = (kCells + kWarpsU - 1) / kWarpsU;
  long long cell[kPerWarp];
  bool live[kPerWarp];
#pragma unroll
  for (int m = 0; m < kPerWarp; ++m) {
    const int e = warp + m * kWarpsU;
    const int r = e / (kTileX + 1);
    const int gy = y - 1 + r;
    const int gx = x0 - 1 + (e - r * (kTileX + 1));
    live[m] = e < kCells && gy >= 0 && gy < cy && gx >= 0 && gx < cx;
    cell[m] = live[m] ? pl.cell_base + static_cast<long long>(gy) * cx + gx
                      : 0;
    live[m] = live[m] && P.flag[cell[m]];
  }
  float v[kPerWarp][2];
#pragma unroll
  for (int m = 0; m < kPerWarp; ++m) {
    const int k0 = warp + m * kWarpsU < kTileX + 1 ? 2 : 0;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      v[m][k] = live[m] && lane < c
                    ? P.cellsum[cell[m] * 4 * c + (k0 + k) * c + lane]
                    : 0.0f;
  }
#pragma unroll
  for (int m = 0; m < kPerWarp; ++m) {
    const int e = warp + m * kWarpsU;
    if (e < kCells && lane < c) {
      const int r = e / (kTileX + 1);
      const int j = e - r * (kTileX + 1);
      sm[r][j][lane] = v[m][0];
      sm[r][j][c + lane] = v[m][1];
    }
  }
  __syncthreads();
  const long long plane_px = static_cast<long long>(pl.h) * pl.w;
  for (int e = threadIdx.x; e < c * kTileX; e += kTileThreads) {
    const int ch = e / kTileX;
    const int xx = e - ch * kTileX;
    const int x = x0 + xx;
    if (x >= pl.w) continue;
    float acc = 0.0f;
    acc = acc + sm[1][xx + 1][ch];       // corner 0 of cell (y, x)
    acc = acc + sm[1][xx][c + ch];       // corner 1 of cell (y, x - 1)
    acc = acc + sm[0][xx + 1][ch];       // corner 2 of cell (y - 1, x)
    acc = acc + sm[0][xx][c + ch];       // corner 3 of cell (y - 1, x - 1)
    pl.out[ch * plane_px + static_cast<long long>(y) * pl.w + x] = acc;
  }
}

__global__ void __launch_bounds__(kDqThreads)
    triplane_bwd_dq_kernel(const __grid_constant__ Params P) {
  const long long nq =
      static_cast<long long>(blockIdx.x) * kDqThreads + threadIdx.x;
  if (nq >= P.n) return;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  const float2* d = reinterpret_cast<const float2*>(P.dterm);
  for (int p = 0; p < P.n_planes; ++p) {
    const float2 t = d[p * P.n + nq];
    const int a = P.plane[p].a;
    const int b = P.plane[p].b;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k == a) acc[k] += t.x;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k == b) acc[k] += t.y;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k < P.qs) P.dq[nq * P.qs + k] = acc[k];
  }
}

}  // namespace

// prob_tab: n_problems rows of (group, rows, shift2, plane0, morton, cx,
// cell_base, block0, 0); plane_tab: n_planes rows of (h, w, a, b,
// cell_base, gcol, f1, f2, 0, 0), f1 = f2 = -1 without the product rule;
// ptrs: q, gout, dq, cellsum, flag, part, part_cell, the terms, then (sorted key, order) per group slot
// (kMaxProblems), then (grid, gradient, sample) per plane slot
// (kMaxPlanes). Returns a cudaError_t (0 on success).
extern "C" int triplane_bwd_launch(const long long* prob_tab, int n_problems,
                                   const long long* plane_tab, int n_planes,
                                   const long long* ptrs, long long n, int c,
                                   int qs, int gs, int block_rows,
                                   long long n_blocks, long long cells,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_problems <= 0 || n_problems > kMaxProblems || n_planes <= 0 ||
      n_planes > kMaxPlanes || c <= 0 || c > kMaxC || qs <= 0 || qs > 3 ||
      n <= 0 || block_rows != kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kGroup0 = 8;
  constexpr int kPlane0 = kGroup0 + 2 * kMaxProblems;
  Params P;
  P.n_problems = n_problems;
  P.n_planes = n_planes;
  P.c = c;
  P.qs = qs;
  P.gs = gs;
  P.n = n;
  P.n_blocks = n_blocks;
  P.q = reinterpret_cast<const float*>(ptrs[0]);
  P.gout = reinterpret_cast<const float*>(ptrs[1]);
  P.dq = reinterpret_cast<float*>(ptrs[2]);
  P.cellsum = reinterpret_cast<float*>(ptrs[3]);
  P.flag = reinterpret_cast<unsigned char*>(ptrs[4]);
  P.part = reinterpret_cast<double*>(ptrs[5]);
  P.part_cell = reinterpret_cast<long long*>(ptrs[6]);
  P.dterm = reinterpret_cast<float*>(ptrs[7]);
  for (int i = 0; i < n_problems; ++i) {
    const long long* r = prob_tab + 9 * i;
    const int gi = static_cast<int>(r[0]);
    Problem& p = P.prob[i];
    p.skey = reinterpret_cast<const int*>(ptrs[kGroup0 + 2 * gi]);
    p.order = reinterpret_cast<const long long*>(ptrs[kGroup0 + 2 * gi + 1]);
    p.rows = r[1];
    p.shift2 = static_cast<int>(r[2]);
    p.plane0 = static_cast<int>(r[3]);
    p.morton = static_cast<int>(r[4]);
    p.cx = static_cast<int>(r[5]);
    p.cell_base = r[6];
    p.block0 = r[7];
  }
  bool product = true;
  long long tiles = 0;
  for (int i = 0; i < n_planes; ++i) {
    const long long* r = plane_tab + 10 * i;
    Plane& p = P.plane[i];
    p.h = static_cast<int>(r[0]);
    p.w = static_cast<int>(r[1]);
    p.a = static_cast<int>(r[2]);
    p.b = static_cast<int>(r[3]);
    p.cell_base = r[4];
    p.gcol = static_cast<int>(r[5]);
    const long long f1 = r[6], f2 = r[7];
    product = product && f1 >= 0 && f2 >= 0;
    p.f1 = f1 >= 0 ? reinterpret_cast<const float*>(ptrs[kPlane0 + 3 * f1 + 2])
                   : nullptr;
    p.f2 = f2 >= 0 ? reinterpret_cast<const float*>(ptrs[kPlane0 + 3 * f2 + 2])
                   : nullptr;
    p.grid = reinterpret_cast<const float*>(ptrs[kPlane0 + 3 * i]);
    p.out = reinterpret_cast<float*>(ptrs[kPlane0 + 3 * i + 1]);
    p.tile0 = tiles;
    if (p.h < 2 || p.w < 2 || p.a >= qs || p.b >= qs)
      return static_cast<int>(cudaErrorInvalidValue);
    tiles += static_cast<long long>(p.h) * ((p.w + kTileX - 1) / kTileX);
  }
  const unsigned tile_ctas = static_cast<unsigned>(tiles);
  cudaError_t err = cudaMemsetAsync(P.flag, 0, cells, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned seg_ctas =
      static_cast<unsigned>((n_blocks + kWarps - 1) / kWarps);
  if (product) {
    triplane_bwd_segment_kernel<true><<<seg_ctas, 32 * kWarps, 0, s>>>(P);
  } else {
    triplane_bwd_segment_kernel<false><<<seg_ctas, 32 * kWarps, 0, s>>>(P);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned part_ctas =
      static_cast<unsigned>((2 * n_blocks + kPartWarps - 1) / kPartWarps);
  triplane_bwd_partial_kernel<<<part_ctas, 32 * kPartWarps, 0, s>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  triplane_bwd_unstack_kernel<<<tile_ctas, kTileThreads, 0, s>>>(P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned dq_ctas =
      static_cast<unsigned>((n + kDqThreads - 1) / kDqThreads);
  triplane_bwd_dq_kernel<<<dq_ctas, kDqThreads, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}
