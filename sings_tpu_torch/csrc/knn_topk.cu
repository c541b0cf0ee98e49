// The exact K nearest valid neighbours of each query row, for Hopper
// (sm_90a): the squared distances to every valid candidate and each
// row's K smallest, ascending, without writing a distance to device
// memory.
//
// Replaces no TPU kernel. The JAX package computes this statistic
// (sings_tpu/ops/knn.py::knn, knn_rows) as a blocked matmul and
// lax.approx_min_k on the TPU, an exact top-k elsewhere, with no
// pallas_call. The port did the same with torch.topk over (4096 x N)
// distance blocks: at the human_complex avatar (127,744 slots, 102,182
// live) 32 blocks of 2 GB written and read back by a multi-block radix
// select, ~460 ms a call, 73% of a training chunk's device time. This
// kernel was added for that. sings_tpu_torch/ops/knn.py::knn and
// knn_rows keep that torch code as the plain version (CPU tensors).
//
// The distance is the plain version's expression, rounded as it is:
//   d2 = (sq_i + sq_j) - 2 dot(q_i, p_j),
//   dot = fmaf(qz, pz, fmaf(qy, py, qx * px))   (nvcc -fmad=false)
// with sq = |p|^2 from ops/knn.py::_sum_squares (XLA's FMA order), passed
// in; fmaf(-2, dot, s) rounds s - 2 dot once, as the subtraction of the
// exact 2 dot does. The wrapper clamps the distances at 0, as before.
//
// Bound on the H100: FP32 issue, not bytes. At the avatar, 127,744 rows
// x 102,182 candidates = 1.31e10 pairs of ~6.5 instructions (five FP32
// operations, a share of the batch's minimum and test), ~2.5 ms at one
// warp instruction a cycle on each of the 528 schedulers; the
// benchmark's count (N_live^2 x 8 operations, 8.35e10) is 1.25 ms at 67
// TFLOP/s. The bytes (the points read once, the lists written once)
// take microseconds. What the design does about it:
//   * it walks far fewer pairs than all, exactly. Rows and candidates go
//     in the order of a Morton curve (the codes here, the sort by torch),
//     so a warp's rows and a tile's candidates each lie in a small box.
//     Each row's list is first seeded with the kSeed valid candidates
//     around its own place on the curve, mostly its near neighbours; then
//     a warp skips every tile whose box lies farther from its rows' box
//     than their largest K-th distance, by more than any rounding of a
//     computed distance (WarpRows::far), so no skipped pair could have
//     entered a list;
//   * in the tiles it walks, nothing but arithmetic is spent per pair: no
//     distance leaves the registers, a candidate is one shared-memory
//     broadcast for kRows rows, and a row tests kBatch candidates against
//     its K-th distance with one branch (their minimum). Insertions, a
//     divergent branch, are rare after the seed: at the avatar a live row
//     inserts 2.7 more candidates in a walk of all 102,182, a dead one 14;
//   * the list of K lives in the thread's local memory (L1), shifted by a
//     runtime count and read at the end: the loop holds just the K-th
//     distance.
//
// Launches (torch's aminmax and sort between the first two), no
// atomics, every result in a fixed order, so two calls give the same
// bits:
//   knn_code_kernel: each slot's 30-bit Morton code in the points'
//     bounding box.
//   knn_count_kernel: per block of kScanThreads ranks of the curve order,
//     its valid slots and its slots in the query range.
//   knn_compact_kernel: each block adds up the counts before it, scans
//     its flags (ballot, popc, one warp over the warp totals) and writes
//     the valid slots in curve order as (x, y, z, sq) float4s with their
//     slot indices, the query slots in curve order with their positions
//     among the valid ones. Block 0 writes the count and pads the list
//     to a whole tile with candidates whose sq is NaN: their distance is
//     NaN and never enters a list. The count stays on the card; the host
//     never waits for it. The dead slots (25,562 of the avatar's
//     127,744) are walked by no one.
//   knn_box_kernel: each tile's box and largest sq.
//   knn_topk_kernel<K>: kThreads threads a CTA, kRows query rows a thread.
//     Seeds each row's list, then stages every tile that some warp cannot
//     skip (kTile float4s and their indices, by cp.async into a double
//     buffer of shared memory, the next one while this one is walked),
//     skipping the seed's positions.
// Ties resolve to the lower index: a list is ordered by (distance, slot
// index), whatever the walk's order. A list with fewer than K valid
// candidates holds +inf in its tail, written with index -1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // threads of a top-k CTA
constexpr int kRows = 2;               // query rows a thread
constexpr int kTile = 512;             // candidates a shared-memory stage
constexpr int kBatch = 8;              // candidates a row tests at once
constexpr int kSeed = 64;              // candidates that seed a row's list
constexpr int kScanThreads = 1024;     // slots a code, count or compact CTA
constexpr int kMaxK = 16;
constexpr int kNone = 0x7fffffff;      // an empty list entry's index
constexpr unsigned kFull = 0xffffffffu;

// the list lengths compiled: a k is served by the shortest list >= k
__host__ __device__ constexpr int list_len(int k) {
  return k < 1 ? 0 : k <= 1 ? 1 : k <= 4 ? 4 : k <= 9 ? 9 : k <= kMaxK ? 16
                                                                        : 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Insert (dd, c) into the sorted list (d, p) of K if it precedes the last
// entry by (distance, index); the caller has seen dd <= d[K - 1], and c
// is in no entry. The list is in the thread's local memory (a shift by a
// runtime count). Returns the new K-th distance.
template <int K>
__device__ __forceinline__ float insert(float* d, int* p, float dd, int c) {
  if (!(dd < d[K - 1] || c < p[K - 1])) return d[K - 1];
  int j = K - 1;
  while (j > 0 && (dd < d[j - 1] || (dd == d[j - 1] && c < p[j - 1]))) {
    d[j] = d[j - 1];
    p[j] = p[j - 1];
    --j;
  }
  d[j] = dd;
  p[j] = c;
  return d[K - 1];
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float dist2(float qx, float qy, float qz,
                                       float qs, const float4& c) {
  const float dot = fmaf(qz, c.z, fmaf(qy, c.y, qx * c.x));
  return fmaf(-2.0f, dot, qs + c.w);
}

struct Args {
  const float* points;        // (n, 3)
  const float* sq;            // (n,)
  const float4* cand;         // (n_pad,) the valid points, then NaN pads
  const int* cand_idx;        // (n_pad,) their slot indices
  const int* qrow;            // (rows,) the query slots, in curve order
  const int* qhome;           // (rows,) each query's position in cand
  const int* count;           // the number of valid slots
  const float4* box;          // (2 n_pad / kTile,) each tile's box
  float* out_d;               // (rows, kout)
  long long* out_i;
  long long n;
  long long row_start;
  long long rows;
  int kout;
};

// Each slot's 30-bit Morton code in the points' bounding box (lohi: the
// (min, max) rows of torch.aminmax), 10 bits an axis: an order only.
__global__ void __launch_bounds__(kScanThreads)
    knn_code_kernel(const float* __restrict__ points,
                    const float* __restrict__ lohi, long long n,
                    int* __restrict__ codes) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  if (i >= n) return;
  const float ext = fmaxf(fmaxf(fmaxf(lohi[3] - lohi[0], lohi[4] - lohi[1]),
                                lohi[5] - lohi[2]),
                          1e-30f);
  unsigned code = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    // fminf and fmaxf return the number where one side is NaN
    const float t = fminf(
        fmaxf((points[3 * i + a] - lohi[a]) / ext * 1023.0f, 0.0f), 1023.0f);
    unsigned x = static_cast<unsigned>(t);
    x = (x | (x << 16)) & 0x030000FFu;
    x = (x | (x << 8)) & 0x0300F00Fu;
    x = (x | (x << 4)) & 0x030C30C3u;
    x = (x | (x << 2)) & 0x09249249u;
    code |= x << a;
  }
  codes[i] = static_cast<int>(code);
}

__global__ void __launch_bounds__(kScanThreads)
    knn_count_kernel(const long long* __restrict__ order,
                     const unsigned char* __restrict__ valid, long long n,
                     long long row_start, long long rows,
                     int* __restrict__ counts) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  const long long i = r < n ? order[r] : -1;
  const int fv = i >= 0 && (valid == nullptr || valid[i] != 0);
  const int fq = i >= row_start && i < row_start + rows;
  const int cv = __syncthreads_count(fv);
  const int cq = __syncthreads_count(fq);
  if (threadIdx.x == 0) {
    counts[2 * blockIdx.x] = cv;
    counts[2 * blockIdx.x + 1] = cq;
  }
}

// The thread's rank among the block's set flags: an exclusive scan by
// the flag's ballot and one warp over the warp totals in s_warp.
__device__ __forceinline__ int block_rank(bool f, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(kFull, f);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int w = s_warp[lane];
    int incl = w;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    s_warp[lane] = incl - w;
  }
  __syncthreads();
  return s_warp[warp] + __popc(ballot & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(kScanThreads)
    knn_compact_kernel(const Args a, const long long* __restrict__ order,
                       const unsigned char* __restrict__ valid,
                       const int* __restrict__ counts, int n_blocks,
                       float4* __restrict__ cand, int* __restrict__ cand_idx,
                       int* __restrict__ qrow, int* __restrict__ qhome,
                       int* __restrict__ count) {
  constexpr int kWarps = kScanThreads / 32;
  static_assert(kWarps == 32, "one warp scans the warp totals");
  __shared__ int s_sum[3][kWarps], s_wv[kWarps], s_wq[kWarps];
  __shared__ int s_base_v, s_base_q, s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int bv = 0, bq = 0, all = 0;
  for (int b = tid; b < n_blocks; b += kScanThreads) {
    const int cv = counts[2 * b];
    all += cv;
    if (b < static_cast<int>(blockIdx.x)) {
      bv += cv;
      bq += counts[2 * b + 1];
    }
  }
  bv = warp_sum(bv);
  bq = warp_sum(bq);
  all = warp_sum(all);
  if (lane == 0) {
    s_sum[0][warp] = bv;
    s_sum[1][warp] = bq;
    s_sum[2][warp] = all;
  }
  __syncthreads();
  if (warp == 0) {
    const int v = warp_sum(s_sum[0][lane]);
    const int q = warp_sum(s_sum[1][lane]);
    const int t = warp_sum(s_sum[2][lane]);
    if (lane == 0) {
      s_base_v = v;
      s_base_q = q;
      s_total = t;
    }
  }
  const long long r = static_cast<long long>(blockIdx.x) * kScanThreads + tid;
  const long long i = r < a.n ? order[r] : -1;
  const bool fv = i >= 0 && (valid == nullptr || valid[i] != 0);
  const bool fq = i >= a.row_start && i < a.row_start + a.rows;
  const int rv = block_rank(fv, s_wv);
  const int rq = block_rank(fq, s_wq);
  const int pos = s_base_v + rv;
  if (fv) {
    cand[pos] = make_float4(a.points[3 * i], a.points[3 * i + 1],
                            a.points[3 * i + 2], a.sq[i]);
    cand_idx[pos] = static_cast<int>(i);
  }
  if (fq) {
    qrow[s_base_q + rq] = static_cast<int>(i);
    qhome[s_base_q + rq] = pos;
  }
  if (blockIdx.x == 0) {
    const int total = s_total;
    const int end = (total + kTile - 1) / kTile * kTile;
    for (int p = total + tid; p < end; p += kScanThreads) {
      cand[p] = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7fc00000));
      cand_idx[p] = kNone;
    }
    if (tid == 0) *count = total;
  }
}

// A row's first kout entries at its place in the output (an empty entry:
// index -1).
__device__ __forceinline__ void write_row(const Args& a, long long lr,
                                          const float* d, const int* p) {
  for (int j = 0; j < a.kout; ++j) {
    a.out_d[lr * a.kout + j] = d[j];
    a.out_i[lr * a.kout + j] = p[j] == kNone ? -1 : p[j];
  }
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Each tile's bounding box of its valid candidates and their largest sq:
// box[2t] = (lo x, y, z, max sq), box[2t + 1] = (hi x, y, z, 0). fminf and
// fmaxf pass over a NaN; an infinite point makes the box (and its sq)
// infinite, so that the tile is never skipped.
__global__ void __launch_bounds__(kThreads)
    knn_box_kernel(const float4* __restrict__ cand,
                   const int* __restrict__ count, float4* __restrict__ box) {
  __shared__ float s_box[kThreads / 32][7];
  const int t = blockIdx.x, m = *count;
  if (static_cast<long long>(t) * kTile >= m) return;
  const float inf = __int_as_float(0x7f800000);
  float v[7] = {inf, inf, inf, -inf, -inf, -inf, -inf};
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const long long pos = static_cast<long long>(t) * kTile + j;
    if (pos < m) {
      const float4 c = cand[pos];
      v[0] = fminf(v[0], c.x);
      v[1] = fminf(v[1], c.y);
      v[2] = fminf(v[2], c.z);
      v[3] = fmaxf(v[3], c.x);
      v[4] = fmaxf(v[4], c.y);
      v[5] = fmaxf(v[5], c.z);
      v[6] = fmaxf(v[6], c.w);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    v[i] = i < 3 ? warp_min(v[i]) : warp_max(v[i]);
    if (lane == 0) s_box[warp][i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w)
      for (int i = 0; i < 7; ++i)
        v[i] = i < 3 ? fminf(v[i], s_box[w][i]) : fmaxf(v[i], s_box[w][i]);
    box[2 * t] = make_float4(v[0], v[1], v[2], v[6]);
    box[2 * t + 1] = make_float4(v[3], v[4], v[5], 0.0f);
  }
}

// A warp's rows: their bounding box, largest sq and largest K-th
// distance (rows past the range count for nothing).
struct WarpRows {
  float lo[3], hi[3], maxsq, thr;
  // True where no pair of these rows and the tile's candidates can reach
  // thr: the boxes' squared distance (in double, from the float corners)
  // exceeds thr by more than any rounding of a computed distance. That
  // rounding is under 9u (|q|^2 + |p|^2), u = 2^-24 (sq's three roundings,
  // the sum's, the dot's chain and the last FMA's); the margin takes 32u.
  __device__ __forceinline__ bool far(const float4* box, int t) const {
    const float4 blo = box[2 * t], bhi = box[2 * t + 1];
    const float tlo[3] = {blo.x, blo.y, blo.z}, thi[3] = {bhi.x, bhi.y, bhi.z};
    double d2 = 0.0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const double gap = fmax(0.0, fmax(static_cast<double>(tlo[i]) - hi[i],
                                        static_cast<double>(lo[i]) - thi[i]));
      d2 += gap * gap;
    }
    const double margin = 32.0 * 5.9604644775390625e-8 *
                          (static_cast<double>(maxsq) + blo.w);
    return d2 > static_cast<double>(thr) + margin;
  }
};

template <int K>
__global__ void __launch_bounds__(kThreads) knn_topk_kernel(const Args a) {
  __shared__ __align__(16) float4 tile[2][kTile];
  __shared__ __align__(16) int tidx[2][kTile];
  const int tid = threadIdx.x;
  const long long q0 = static_cast<long long>(blockIdx.x) * (kRows * kThreads);
  const int m = *a.count;
  const float inf = __int_as_float(0x7f800000);
  float qx[kRows], qy[kRows], qz[kRows], qs[kRows], thr[kRows];
  long long lr[kRows];
  int lo[kRows];
  float d[kRows][K];
  int p[kRows][K];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long q = q0 + r * kThreads + tid;
    const long long qc = q < a.rows ? q : q0;
    const long long row = a.qrow[qc];
    lr[r] = q < a.rows ? row - a.row_start : -1;
    qx[r] = a.points[3 * row];
    qy[r] = a.points[3 * row + 1];
    qz[r] = a.points[3 * row + 2];
    qs[r] = a.sq[row];
    lo[r] = min(max(a.qhome[qc] - kSeed / 2, 0), max(m - kSeed, 0));
    thr[r] = inf;
    for (int j = 0; j < K; ++j) {
      d[r][j] = inf;
      p[r][j] = kNone;
    }
  }
  // the seed: the kSeed valid candidates around each row's own place on
  // the curve, mostly its near neighbours, so that the K-th distance
  // starts close to its final value
#pragma unroll 1
  for (int u = 0; u < kSeed; ++u) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int pos = lo[r] + u;
      if (pos < m) {
        const float dd = dist2(qx[r], qy[r], qz[r], qs[r], a.cand[pos]);
        if (dd <= thr[r])
          thr[r] = insert<K>(d[r], p[r], dd, a.cand_idx[pos]);
      }
    }
  }
  WarpRows w;
  {
    float lo3[3] = {inf, inf, inf}, hi3[3] = {-inf, -inf, -inf};
    float ms = -inf, th = -inf;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (lr[r] < 0) continue;
      lo3[0] = fminf(lo3[0], qx[r]);
      lo3[1] = fminf(lo3[1], qy[r]);
      lo3[2] = fminf(lo3[2], qz[r]);
      hi3[0] = fmaxf(hi3[0], qx[r]);
      hi3[1] = fmaxf(hi3[1], qy[r]);
      hi3[2] = fmaxf(hi3[2], qz[r]);
      ms = fmaxf(ms, qs[r]);
      th = fmaxf(th, thr[r]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      w.lo[i] = warp_min(lo3[i]);
      w.hi[i] = warp_max(hi3[i]);
    }
    w.maxsq = warp_max(ms);
    w.thr = warp_max(th);
  }
  // the walk: every tile that some warp of the CTA cannot rule out by its
  // box; a warp computes only the tiles it cannot rule out itself
  const int ntiles = (m + kTile - 1) / kTile;
  const float4* box = a.box;
  auto next_kept = [&](int t) {
    for (; t < ntiles; ++t)
      if (__syncthreads_or(!w.far(box, t))) return t;
    return ntiles;
  };
  auto stage = [&](int t, int b) {
    for (int j = tid; j < kTile; j += kThreads)
      cp_async16(&tile[b][j], a.cand + static_cast<long long>(t) * kTile + j);
    for (int j = tid; j < kTile / 4; j += kThreads)
      cp_async16(&tidx[b][4 * j],
                 a.cand_idx + static_cast<long long>(t) * kTile + 4 * j);
    cp_async_commit();
  };
  int cur = next_kept(0);
  if (cur < ntiles) stage(cur, 0);
  for (int i = 0; cur < ntiles; ++i) {
    const int nxt = next_kept(cur + 1);
    if (nxt < ntiles) {
      stage(nxt, (i + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!w.far(box, cur)) {
      const float4* buf = tile[i & 1];
      const int* ibuf = tidx[i & 1];
      const int base = cur * kTile;
#pragma unroll 2
      for (int j = 0; j < kTile; j += kBatch) {
        float4 c[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) c[u] = buf[j + u];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float dd[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            dd[u] = dist2(qx[r], qy[r], qz[r], qs[r], c[u]);
          // one test for the batch (fminf drops a NaN pad's distance)
          float least = dd[0];
#pragma unroll
          for (int u = 1; u < kBatch; ++u) least = fminf(least, dd[u]);
          if (least <= thr[r]) {
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              // a seed position is in the list already
              if (dd[u] <= thr[r] &&
                  static_cast<unsigned>(base + j + u - lo[r]) >=
                      static_cast<unsigned>(kSeed))
                thr[r] = insert<K>(d[r], p[r], dd[u], ibuf[j + u]);
            }
          }
        }
      }
      float th = -inf;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (lr[r] >= 0) th = fmaxf(th, thr[r]);
      w.thr = warp_max(th);
    }
    __syncthreads();
    cur = nxt;
  }
  for (int r = 0; r < kRows; ++r)
    if (lr[r] >= 0) write_row(a, lr[r], d[r], p[r]);
}

size_t aligned(size_t bytes) { return (bytes + 255) / 256 * 256; }

struct Layout {
  size_t counts, count, cand, cand_idx, qrow, qhome, box, total;
};

Layout layout(long long n, long long rows) {
  const long long n_blocks = (n + kScanThreads - 1) / kScanThreads;
  const long long n_pad = (n + kTile - 1) / kTile * kTile;
  Layout l;
  l.counts = 0;
  l.count = l.counts + aligned(8 * n_blocks);
  l.cand = l.count + aligned(4);
  l.cand_idx = l.cand + aligned(16 * n_pad);
  l.qrow = l.cand_idx + aligned(4 * n_pad);
  l.qhome = l.qrow + aligned(4 * rows);
  l.box = l.qhome + aligned(4 * rows);
  l.total = l.box + aligned(32 * (n_pad / kTile));
  return l;
}

template <int K>
cudaError_t launch(const Args& a0, const unsigned char* valid,
                   const long long* order, char* scratch, cudaStream_t s) {
  const Layout l = layout(a0.n, a0.rows);
  Args a = a0;
  int* counts = reinterpret_cast<int*>(scratch + l.counts);
  int* count = reinterpret_cast<int*>(scratch + l.count);
  float4* cand = reinterpret_cast<float4*>(scratch + l.cand);
  int* cand_idx = reinterpret_cast<int*>(scratch + l.cand_idx);
  int* qrow = reinterpret_cast<int*>(scratch + l.qrow);
  int* qhome = reinterpret_cast<int*>(scratch + l.qhome);
  float4* box = reinterpret_cast<float4*>(scratch + l.box);
  a.cand = cand;
  a.cand_idx = cand_idx;
  a.qrow = qrow;
  a.qhome = qhome;
  a.count = count;
  a.box = box;
  const int n_blocks =
      static_cast<int>((a.n + kScanThreads - 1) / kScanThreads);
  knn_count_kernel<<<n_blocks, kScanThreads, 0, s>>>(
      order, valid, a.n, a.row_start, a.rows, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_compact_kernel<<<n_blocks, kScanThreads, 0, s>>>(
      a, order, valid, counts, n_blocks, cand, cand_idx, qrow, qhome, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_box_kernel<<<static_cast<unsigned>((a.n + kTile - 1) / kTile), kThreads,
                   0, s>>>(cand, count, box);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long per_block = static_cast<long long>(kRows) * kThreads;
  knn_topk_kernel<K><<<static_cast<unsigned>((a.rows + per_block - 1) /
                                             per_block),
                       kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the scratch buffer a call with these sizes needs.
extern "C" long long knn_topk_scratch_bytes(long long n, long long rows) {
  return static_cast<long long>(layout(n, rows).total);
}

// The first launch: every slot's Morton code (int32, n), for the caller
// to sort stably into the walk's order. lohi: (2, 3) float32 on the card,
// the points' (min, max) by axis.
extern "C" int knn_topk_codes(const float* points, const float* lohi,
                              long long n, int* codes, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  knn_code_kernel<<<static_cast<unsigned>((n + kScanThreads - 1) /
                                          kScanThreads),
                    kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      points, lohi, n, codes);
  return static_cast<int>(cudaGetLastError());
}

// The k nearest valid slots of the query rows [row_start, row_start + rows)
// among all n slots: distances (rows, k) float32 ascending, indices (rows,
// k) int64. valid may be null (every slot valid). order: (n,) int64, the
// slots sorted by knn_topk_codes' codes. scratch holds
// knn_topk_scratch_bytes(n, rows) bytes, 256-byte aligned.
extern "C" int knn_topk_launch(const float* points, const float* sq,
                               const unsigned char* valid,
                               const long long* order, long long n,
                               long long row_start, long long rows, int k,
                               void* scratch, float* out_d, long long* out_i,
                               void* stream) {
  if (n <= 0 || n > 0x7fffffffLL - kTile || rows <= 0 || row_start < 0 ||
      row_start + rows > n || list_len(k) == 0 || k > n ||
      (reinterpret_cast<uintptr_t>(scratch) & 255) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.points = points;
  a.sq = sq;
  a.out_d = out_d;
  a.out_i = out_i;
  a.n = n;
  a.row_start = row_start;
  a.rows = rows;
  a.kout = k;
  char* sc = static_cast<char*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (list_len(k)) {
    case 1: return static_cast<int>(launch<1>(a, valid, order, sc, s));
    case 4: return static_cast<int>(launch<4>(a, valid, order, sc, s));
    case 9: return static_cast<int>(launch<9>(a, valid, order, sc, s));
    case 16: return static_cast<int>(launch<16>(a, valid, order, sc, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
