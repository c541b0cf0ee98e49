// Grid gradients of bilinear sampling, for Hopper (sm_90a).
//
// Replaces the grid-gradient half of the JAX package's custom backwards
// (XLA, no pallas_call): sings_tpu/ops/sampling.py::_sample_bwd,
// sings_tpu/fields/triplane.py::_triplane_fused_bwd and
// _triplane_nested_bwd, from lax.sort_key_val to the (C, H, W)
// gradients. Given each sort group's keys sorted (with their order, the
// query index of each sorted row), it computes for every cell of every
// plane the sum over the cell's queries of the four corner rows
// w_k(tx, ty) * g (k = 00, 01, 10, 11), then adds the corner blocks back
// onto the grid points. sings_tpu_torch/ops/grid_grad.py::grid_grad_plain
// is the same function in PyTorch.
//
// A problem is one segment reduction over one group's sorted rows: a
// sorted row i has query j = order[i], plane plane0 + j / n, and
// segment key skey[i] >> shift2 (the nested triplane's level-l cell is
// the fine Morton code shifted right by 2 shift_l, so one sort serves
// every level). Its cell is cell_base + the key (row-major keys) or
// cell_base + y * cx + x with (x, y) de-interleaved from the key.
//
// Three kernels, no float atomics, a fixed order of every sum, so two
// calls give the same bits:
//   grid_grad_segment_kernel: one warp per block of kRows sorted rows of
//     a problem (and 32 channels). The warp stages the block's keys,
//     source rows and weights in shared memory, then walks the rows in
//     order, the lanes on the channels, forming w_k * g on the fly (the
//     (N, 4C) rows are never written) and summing in float64. A segment
//     wholly inside the block is rounded once and written to its cell's
//     (4, C) row; the block's first and last segment go to partial slots
//     2b and 2b + 1 (a block of one segment writes it to 2b, and zeros
//     under the same cell to 2b + 1). So a long segment (the 25,562 dead
//     slots of the avatar at xyz = 0 share one cell at every level) is
//     spread over many warps instead of one.
//   grid_grad_partial_kernel: one warp per partial slot; a slot that
//     starts a run of equal cells sums the run's slots in slot order and
//     writes the cell's row. A run holds 2 slots per kRows rows of its
//     segment.
//   grid_grad_unstack_kernel: one CTA per (plane, grid row y, 32 grid
//     columns). The cell rows y - 1 and y of 33 columns (those no segment
//     wrote read as zero, by the per-cell flag) go through shared memory,
//     then each grid point adds corner 0 of cell (y, x), 1 of (y, x - 1),
//     2 of (y - 1, x), 3 of (y - 1, x - 1) in that order (JAX's four
//     slice-adds) and is written in (C, H, W) order.
//
// Bound on the H100: bytes. Every query's tx, ty and cotangent row are
// read once per plane (the products need 4 multiplies and 4 adds a
// channel, far below the card's rate), the gradients written once; at
// the nested 64^3 triplane of 127,744 queries, C = 32 and multires
// [1, 2, 4] that is 9 x 127,744 x (32 + 2) x 4 bytes in and 33.4 MB out,
// ~0.06 ms at 3.35 TB/s. The design keeps the rows out of device memory,
// reads each cotangent row with one 128-byte load per warp, and spreads
// long segments over blocks; the cell sums take one float32 (4, C) row
// per occupied cell plus the partial slots, written and read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 256;        // sorted rows per block
constexpr int kWarps = 4;         // warps per CTA of the first two passes
constexpr int kUnroll = 8;        // cotangent loads in flight per lane
constexpr int kMaxProblems = 16;
constexpr int kMaxPlanes = 16;
constexpr int kTileX = 32;        // grid columns per unstack CTA
constexpr int kUnstackThreads = 256;

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
  long long cell_base;
  long long tile0;      // first unstack CTA of the plane
  float* out;
  int h;
  int w;
};

struct Params {
  Problem prob[kMaxProblems];
  Plane plane[kMaxPlanes];
  int n_problems;
  int n_planes;
  int c;
  int n_chunks;         // ceil(c / 32)
  long long n;          // queries per plane
  long long n_blocks;
  const float* tx;
  const float* ty;
  const float* gout;
  float* cellsum;       // (cells, 4c), rows of occupied cells written
  unsigned char* flag;  // (cells,), zeroed; 1 where a row was written
  double* part;         // (2 n_blocks, 4c)
  long long* part_cell; // (2 n_blocks,)
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

__global__ void __launch_bounds__(32 * kWarps)
    grid_grad_segment_kernel(const Params P) {
  __shared__ int s_seg[kWarps][kRows];
  __shared__ int s_src[kWarps][kRows];
  __shared__ float s_w[kWarps][4][kRows];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (item >= P.n_blocks * P.n_chunks) return;
  const long long blk = item / P.n_chunks;
  const int chunk = static_cast<int>(item - blk * P.n_chunks);
  int pi = 0;
  while (pi + 1 < P.n_problems && P.prob[pi + 1].block0 <= blk) ++pi;
  const Problem& pr = P.prob[pi];
  const long long r0 = (blk - pr.block0) * kRows;
  const int nr = static_cast<int>(min(static_cast<long long>(kRows),
                                      pr.rows - r0));
  for (int i = lane; i < nr; i += 32) {
    const long long j = pr.order[r0 + i];
    const long long q = j / P.n;
    const long long src = (pr.plane0 + q) * P.n + (j - q * P.n);
    s_seg[warp][i] = pr.skey[r0 + i] >> pr.shift2;
    s_src[warp][i] = static_cast<int>(src);
    const float tx = P.tx[src];
    const float ty = P.ty[src];
    s_w[warp][0][i] = (1.0f - tx) * (1.0f - ty);
    s_w[warp][1][i] = tx * (1.0f - ty);
    s_w[warp][2][i] = (1.0f - tx) * ty;
    s_w[warp][3][i] = tx * ty;
  }
  __syncwarp();
  const int ch = chunk * 32 + lane;
  const bool on = ch < P.c;
  const long long slot0 = 2 * blk;
  double a[4] = {0.0, 0.0, 0.0, 0.0};
  int cur = s_seg[warp][0];
  int runs = 0;  // segments of this block finished so far
  for (int i0 = 0; i0 < nr; i0 += kUnroll) {
    float g[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u;
      g[u] = (on && i < nr)
                 ? __ldg(P.gout + static_cast<long long>(s_src[warp][i]) *
                                      P.c + ch)
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u;
      if (i < nr) {
        const int seg = s_seg[warp][i];
        if (seg != cur) {
          const long long cell = cell_of(pr, cur);
          if (runs == 0) {
            write_part(P, slot0, cell, ch, on, lane, a);
          } else {
            write_cell(P, cell, ch, on, lane, a);
          }
          ++runs;
          cur = seg;
#pragma unroll
          for (int k = 0; k < 4; ++k) a[k] = 0.0;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          a[k] += static_cast<double>(s_w[warp][k][i] * g[u]);
      }
    }
  }
  const long long cell = cell_of(pr, cur);
  if (runs == 0) {
    write_part(P, slot0, cell, ch, on, lane, a);
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = 0.0;
  }
  write_part(P, slot0 + 1, cell, ch, on, lane, a);
}

__global__ void __launch_bounds__(32 * kWarps)
    grid_grad_partial_kernel(const Params P) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long slot = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long n_slots = 2 * P.n_blocks;
  if (slot >= n_slots) return;
  const long long cell = P.part_cell[slot];
  if (slot > 0 && P.part_cell[slot - 1] == cell) return;
  // the run's end: 32 slots compared per step, the first mismatch by ballot
  long long end = slot + 1;
  for (;;) {
    const long long s = end + lane;
    const bool same = s < n_slots && P.part_cell[s] == cell;
    const unsigned m = __ballot_sync(0xffffffffu, same);
    if (m != 0xffffffffu) {
      end += __ffs(~m) - 1;
      break;
    }
    end += 32;
  }
  for (int c0 = 0; c0 < P.c; c0 += 32) {
    const int ch = c0 + lane;
    const bool on = ch < P.c;
    double a[4] = {0.0, 0.0, 0.0, 0.0};
    if (on) {
#pragma unroll 4
      for (long long s = slot; s < end; ++s) {
        const double* row = P.part + s * 4 * P.c;
#pragma unroll
        for (int k = 0; k < 4; ++k) a[k] += row[k * P.c + ch];
      }
    }
    write_cell(P, cell, ch, on, lane, a);
  }
}

__global__ void __launch_bounds__(kUnstackThreads)
    grid_grad_unstack_kernel(const Params P) {
  extern __shared__ float sm[];
  const long long t = blockIdx.x;
  int pi = 0;
  while (pi + 1 < P.n_planes && P.plane[pi + 1].tile0 <= t) ++pi;
  const Plane& pl = P.plane[pi];
  const int tiles_x = (pl.w + kTileX - 1) / kTileX;
  const long long lt = t - pl.tile0;
  const int y = static_cast<int>(lt / tiles_x);
  const int x0 = static_cast<int>(lt - static_cast<long long>(y) * tiles_x) *
                 kTileX;
  const int cy = pl.h - 1;
  const int cx = pl.w - 1;
  const int c = P.c;
  const int c4 = 4 * c;
  const int stride = c4 + 1;  // odd: the compute loop's reads hit 32 banks
  const int per_row = (kTileX + 1) * c4;
  for (int e = threadIdx.x; e < 2 * per_row; e += blockDim.x) {
    const int r = e / per_row;
    const int rem = e - r * per_row;
    const int j = rem / c4;
    const int k = rem - j * c4;
    const int gy = y - 1 + r;
    const int gx = x0 - 1 + j;
    float v = 0.0f;
    if (gy >= 0 && gy < cy && gx >= 0 && gx < cx) {
      const long long cell =
          pl.cell_base + static_cast<long long>(gy) * cx + gx;
      if (P.flag[cell]) v = P.cellsum[cell * c4 + k];
    }
    sm[(r * (kTileX + 1) + j) * stride + k] = v;
  }
  __syncthreads();
  const float* row_above = sm;                           // cells y - 1
  const float* row_here = sm + (kTileX + 1) * stride;    // cells y
  const long long plane_px = static_cast<long long>(pl.h) * pl.w;
  for (int e = threadIdx.x; e < c * kTileX; e += blockDim.x) {
    const int ch = e / kTileX;
    const int xx = e - ch * kTileX;
    const int x = x0 + xx;
    if (x >= pl.w) continue;
    float acc = 0.0f;
    acc = acc + row_here[(xx + 1) * stride + 0 * c + ch];
    acc = acc + row_here[xx * stride + 1 * c + ch];
    acc = acc + row_above[(xx + 1) * stride + 2 * c + ch];
    acc = acc + row_above[xx * stride + 3 * c + ch];
    pl.out[ch * plane_px + static_cast<long long>(y) * pl.w + x] = acc;
  }
}

}  // namespace

// prob_tab: n_problems rows of (skey, order, rows, shift2, plane0, morton,
// cx, cell_base, block0); plane_tab: n_planes rows of (h, w, cell_base,
// out). Returns a cudaError_t (0 on success).
extern "C" int grid_grad_launch(const long long* prob_tab, int n_problems,
                                const long long* plane_tab, int n_planes,
                                const float* tx, const float* ty,
                                const float* gout, long long n, int c,
                                float* cellsum, unsigned char* flag,
                                double* part, long long* part_cell,
                                long long n_blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_problems > kMaxProblems || n_planes > kMaxPlanes || n_planes <= 0 ||
      c <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params P;
  P.n_problems = n_problems;
  P.n_planes = n_planes;
  P.c = c;
  P.n_chunks = (c + 31) / 32;
  P.n = n;
  P.n_blocks = n_blocks;
  P.tx = tx;
  P.ty = ty;
  P.gout = gout;
  P.cellsum = cellsum;
  P.flag = flag;
  P.part = part;
  P.part_cell = part_cell;
  for (int i = 0; i < n_problems; ++i) {
    const long long* r = prob_tab + 9 * i;
    Problem& p = P.prob[i];
    p.skey = reinterpret_cast<const int*>(r[0]);
    p.order = reinterpret_cast<const long long*>(r[1]);
    p.rows = r[2];
    p.shift2 = static_cast<int>(r[3]);
    p.plane0 = static_cast<int>(r[4]);
    p.morton = static_cast<int>(r[5]);
    p.cx = static_cast<int>(r[6]);
    p.cell_base = r[7];
    p.block0 = r[8];
  }
  long long tiles = 0;
  long long cells = 0;
  for (int i = 0; i < n_planes; ++i) {
    const long long* r = plane_tab + 4 * i;
    Plane& p = P.plane[i];
    p.h = static_cast<int>(r[0]);
    p.w = static_cast<int>(r[1]);
    p.cell_base = r[2];
    p.out = reinterpret_cast<float*>(r[3]);
    p.tile0 = tiles;
    tiles += static_cast<long long>(p.h) * ((p.w + kTileX - 1) / kTileX);
    cells = p.cell_base + static_cast<long long>(p.h - 1) * (p.w - 1);
  }
  cudaError_t err = cudaMemsetAsync(flag, 0, cells, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks > 0) {
    const long long items = n_blocks * P.n_chunks;
    const unsigned seg_ctas =
        static_cast<unsigned>((items + kWarps - 1) / kWarps);
    grid_grad_segment_kernel<<<seg_ctas, 32 * kWarps, 0, s>>>(P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned part_ctas =
        static_cast<unsigned>((2 * n_blocks + kWarps - 1) / kWarps);
    grid_grad_partial_kernel<<<part_ctas, 32 * kWarps, 0, s>>>(P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = sizeof(float) * 2 * (kTileX + 1) * (4 * c + 1);
  err = cudaFuncSetAttribute(grid_grad_unstack_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  grid_grad_unstack_kernel<<<static_cast<unsigned>(tiles), kUnstackThreads,
                             smem, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}
