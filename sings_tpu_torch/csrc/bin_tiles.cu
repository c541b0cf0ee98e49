// Tile binning for the rasterizer, for Hopper (sm_90a): every gaussian's
// (tile, depth) pairs grouped by tile in depth order, and the offset and
// slot tables that the composite kernels and their backward glue read.
// The fields are sings_tpu_torch/ops/rasterizer/tiles.py's plain
// version's integer for integer on the same CUDA inputs.
//
// Replaces no TPU kernel. The JAX package bins with XLA code
// (sings_tpu/ops/rasterizer/tiles.py::bin_gaussians, no pallas_call); the
// port did the same with torch ops: three sorts (the depth argsort, a
// per-row argsort that compacts each gaussian's pairs to pair_cap, the key
// sort) and ~278 launches a call, four of them boolean-mask indexings
// whose nonzero makes the host wait for the card. At the human_complex
// animation frame (127,744 gaussians, 32 x 32 tiles, pair_cap 4) on an
// H100 that was ~1.6 ms of device time a frame, and the binning held 42%
// of the render's idle device time: the host issued and waited while the
// card idled. These kernels were added for that. tiles.py keeps the torch
// code as the plain version (CPU tensors).
//
// Bound on the H100: bytes. The inputs (~5 MB: means, depths, conics,
// opacity thresholds, radii, mask), the 64-bit keys and pair-slot table
// written, sorted (torch.sort, a few passes over ~8 MB) and read back:
// ~25 MB in all at 3.35 TB/s, ~8 us. What the design does about it: the
// per-pair work is done once, in registers, by the thread of its
// gaussian; the keys carry the depth's bits, so one sort orders the pairs
// by (tile, depth, gaussian) and the depth argsort and the rank scatter
// go; nothing is read back, and every shape is set by the arguments, so
// the host never waits.
//
// Launches (torch.sort between the first and the last two):
//   a memset of the overflow counter;
//   bin_emit_kernel: one thread a gaussian. Its tile rectangle (common.py
//     tile_rect), the crop to max_span around its centre tile, the
//     per-pair cull and the valid_tiles_y test, in tiles.py's float32
//     operations and order (nvcc -fmad=false; the cull's threshold
//     log(max(opacity, 1e-12) * 255) comes from torch's own log); then,
//     compacting to the first pair_cap survivors where pair_cap applies,
//     one key a (gaussian, slot): (tile << 32) | depth_bits(depth), or
//     kInvalid. Also the pair-slot table filled with the spare slot, the
//     pairs each gaussian spans, and the overflow of the crop and of the
//     compaction (a block sum, one integer atomic a block: exact in any
//     order);
//   bin_tiles_kernel: one CTA. Each tile's offset by binary search over
//     the sorted keys' prefix, the valid pairs, the final overflow, each
//     tile's padded gradient region and their scan (grad_offsets), each
//     tile's slot shift;
//   bin_slots_kernel: one thread a sorted pair of the prefix. Its
//     gaussian, its slot i + shift[tile] and the inverse scatter into the
//     pair-slot table. No nonzero: each pair reads its tile in its key.
// Every output is written in a fixed order, so two calls give the same
// bits.
//
// The sort key. tiles.py sorts tile * N + rank, rank from a stable depth
// argsort: a tile's pairs by (depth, gaussian index). Here the low 32 bits
// are the depth's float bits mapped to an order-preserving unsigned code
// (-0 as +0, NaN last, as torch orders floats), and a stable sort keeps
// equal keys in (gaussian, slot) order, which is the same order: a
// gaussian has one pair a tile. Valid keys are below 2^63 - 1 (tile <
// 2^31 - 1), so torch's signed sort leaves kInvalid last.

#include <cuda_runtime.h>
#include <stdint.h>

// The launchers' arguments, at namespace scope so that the extern "C"
// launchers keep external linkage; every field 8 bytes (ctypes mirrors
// them in ops/rasterizer/tiles.py).
struct BinEmitArgs {
  const float* means;        // (N, 2), element strides below
  long long means_s0, means_s1;
  const float* depths;
  long long depths_s;
  const float* conics;       // (N, 3)
  long long conics_s0, conics_s1;
  const float* thr;          // (N,) contiguous cull thresholds; null: no cull
  const int* radii;
  long long radii_s;
  const unsigned char* mask;  // bool
  long long mask_s;
  const int* vty_dev;        // 0-d int32 valid_tiles_y on the card, or null
  long long vty;             // valid_tiles_y when vty_dev is null
  long long n;
  long long tile, ntx, nty, max_span;
  long long cap;             // slots a gaussian: max_span^2 or pair_cap
  long long compact;         // 1: keep the first cap surviving pairs
  long long spare;           // the spare slot, grad capacity - 1
  long long* keys;           // (N * cap)
  int* pair_slot;            // (N * cap)
  int* span;                 // (N,) or null
  int* tail_of_gauss;        // (N,) zeroed, or null
  unsigned long long* overflow;  // one counter, zeroed here
};

struct BinFinishArgs {
  const long long* sorted_key;   // (p,)
  const long long* sorted_flat;  // (p,)
  long long p, take, pk, cap, n_tiles, align, pg;
  const unsigned long long* overflow;
  int* tile_offsets;   // (T + 1,)
  int* grad_offsets;   // (T + 1,)
  int* shift;          // (T,) scratch
  int* num_pairs;      // ()
  int* overflow_out;   // ()
  int* sorted_gauss;   // (pk,)
  int* pair_slot;      // (N * cap)
};

namespace {

constexpr int kEmitThreads = 256;
constexpr int kTileThreads = 1024;
constexpr int kSlotThreads = 256;
constexpr long long kInvalid = 0x7fffffffffffffffLL;
constexpr unsigned kFull = 0xffffffffu;

// torch.maximum / torch.minimum: a NaN on either side propagates
__device__ __forceinline__ float t_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float t_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

// torch.clamp and torch.clamp_min of a float tensor by scalars
__device__ __forceinline__ float t_clamp(float v, float lo, float hi) {
  if (v != v) return v;
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  if (v != v) return v;
  return fmaxf(v, lo);
}

// torch.div(a, b, rounding_mode="floor") for a float tensor and a scalar
// b on CUDA: the reciprocal product and its corrections
__device__ __forceinline__ float t_floor_div(float a, float b, float inv_b) {
  const float mod = fmodf(a, b);
  float div = (a - mod) * inv_b;
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) div -= 1.0f;
  if (div == 0.0f) return copysignf(0.0f, a * inv_b);
  float fl = floorf(div);
  if (div - fl > 0.5f) fl += 1.0f;
  return fl;
}

// The depth's order as an unsigned code: -0 as +0, every NaN last.
__device__ __forceinline__ unsigned depth_bits(float d) {
  unsigned u = __float_as_uint(d);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;
  if ((u & 0x7fffffffu) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// tiles.py's cull: can the peak alpha over the tile's pixel box
// [bx0, bx0 + tile - 1] x [by0, by0 + tile - 1] (relative to the mean)
// reach 1/255? The conic quadratic minimised over the box's edges.
__device__ __forceinline__ bool reaches(float a, float b, float c, float a_s,
                                        float c_s, float bx0, float by0,
                                        float tile_m1, float thr) {
  const float bx1 = bx0 + tile_m1;
  const float by1 = by0 + tile_m1;
  const auto qx = [&](float x) {
    const float yy = t_min(t_max(-b * x / c_s, by0), by1);
    return (0.5f * a * x + b * yy) * x + 0.5f * c * yy * yy;
  };
  const auto qy = [&](float y) {
    const float xx = t_min(t_max(-b * y / a_s, bx0), bx1);
    return (0.5f * c * y + b * xx) * y + 0.5f * a * xx * xx;
  };
  const bool inside = bx0 <= 0.0f && bx1 >= 0.0f && by0 <= 0.0f &&
                      by1 >= 0.0f;
  float q_min = t_min(t_min(qx(bx0), qx(bx1)), t_min(qy(by0), qy(by1)));
  if (inside) q_min = 0.0f;
  return q_min <= thr;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kEmitThreads)
    bin_emit_kernel(const BinEmitArgs a) {
  __shared__ long long s_over[kEmitThreads / 32];
  const long long i =
      static_cast<long long>(blockIdx.x) * kEmitThreads + threadIdx.x;
  long long over = 0;
  if (i < a.n) {
    const float tile_f = static_cast<float>(a.tile);
    const float inv_t = 1.0f / tile_f;
    const float mx = a.means[i * a.means_s0];
    const float my = a.means[i * a.means_s0 + a.means_s1];
    // common.py tile_rect: floor for the low corner, truncation for the
    // high one, clamped to the grid, as int32
    const float r = static_cast<float>(a.radii[i * a.radii_s]);
    const long long x0 = static_cast<int>(
        t_clamp(floorf((mx - r) * inv_t), 0.0f, static_cast<float>(a.ntx)));
    const long long y0 = static_cast<int>(
        t_clamp(floorf((my - r) * inv_t), 0.0f, static_cast<float>(a.nty)));
    const long long x1 = static_cast<int>(t_clamp(
        truncf((mx + r + tile_f - 1.0f) * inv_t), 0.0f,
        static_cast<float>(a.ntx)));
    const long long y1 = static_cast<int>(t_clamp(
        truncf((my + r + tile_f - 1.0f) * inv_t), 0.0f,
        static_cast<float>(a.nty)));
    const long long w = x1 - x0, h = y1 - y0, s = a.max_span;
    long long cx = static_cast<int>(t_floor_div(mx, tile_f, inv_t));
    long long cy = static_cast<int>(t_floor_div(my, tile_f, inv_t));
    cx = min(max(cx, 0LL), a.ntx - 1);
    cy = min(max(cy, 0LL), a.nty - 1);
    const long long x0c = w > s ? min(max(cx - s / 2, x0), x1 - s) : x0;
    const long long y0c = h > s ? min(max(cy - s / 2, y0), y1 - s) : y0;
    const long long wc = min(w, s), hc = min(h, s);
    const bool m = a.mask[i * a.mask_s] != 0;
    over = m ? w * h - wc * hc : 0;
    const long long span0 = m && w > 0 && h > 0 ? wc * hc : 0;
    const long long wc_safe = max(wc, 1LL);

    const bool cull = a.thr != nullptr;
    float ca = 0.0f, cb = 0.0f, cc = 0.0f, ca_s = 0.0f, cc_s = 0.0f;
    float thr = 0.0f;
    if (cull && span0 > 0) {
      const float* con = a.conics + i * a.conics_s0;
      ca = con[0];
      cb = con[a.conics_s1];
      cc = con[2 * a.conics_s1];
      ca_s = t_clamp_min(ca, static_cast<float>(1e-12));
      cc_s = t_clamp_min(cc, static_cast<float>(1e-12));
      thr = a.thr[i];
    }
    const long long vty = a.vty_dev != nullptr ? *a.vty_dev : a.vty;
    const unsigned dbits = depth_bits(a.depths[i * a.depths_s]);
    long long* keys = a.keys + i * a.cap;
    long long nvalid = 0, last = 0;
    for (long long j = 0; j < span0; ++j) {
      const long long tx = x0c + j % wc_safe, ty = y0c + j / wc_safe;
      bool ok = ty < vty;
      if (ok && cull)
        ok = reaches(ca, cb, cc, ca_s, cc_s,
                     static_cast<float>(tx) * tile_f - mx,
                     static_cast<float>(ty) * tile_f - my, tile_f - 1.0f,
                     thr);
      const long long key =
          ok ? ((ty * a.ntx + tx) << 32) | static_cast<long long>(dbits)
             : kInvalid;
      if (a.compact) {
        if (ok && nvalid < a.cap) keys[nvalid] = key;
      } else {
        keys[j] = key;
      }
      if (ok) {
        ++nvalid;
        last = j + 1;
      }
    }
    long long sp;
    if (a.compact) {
      for (long long k = min(nvalid, a.cap); k < a.cap; ++k) keys[k] = kInvalid;
      sp = min(nvalid, a.cap);
      over += max(nvalid - a.cap, 0LL);
    } else {
      for (long long k = span0; k < a.cap; ++k) keys[k] = kInvalid;
      sp = last;
    }
    int* ps = a.pair_slot + i * a.cap;
    for (long long k = 0; k < a.cap; ++k) ps[k] = static_cast<int>(a.spare);
    if (a.span != nullptr) a.span[i] = static_cast<int>(sp);
    if (a.tail_of_gauss != nullptr) a.tail_of_gauss[i] = 0;
  }
  over = warp_sum(over);
  if ((threadIdx.x & 31) == 0) s_over[threadIdx.x >> 5] = over;
  __syncthreads();
  if (threadIdx.x < 32) {
    over = threadIdx.x < kEmitThreads / 32 ? s_over[threadIdx.x] : 0;
    over = warp_sum(over);
    if (threadIdx.x == 0 && over != 0)
      atomicAdd(a.overflow, static_cast<unsigned long long>(over));
  }
}

// The first index of sorted[0, len) that is >= target.
__device__ __forceinline__ long long lower_bound(const long long* sorted,
                                                 long long len,
                                                 long long target) {
  long long lo = 0, hi = len;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (sorted[mid] < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// An inclusive scan over the CTA (kTileThreads threads); s_warp holds 32.
__device__ __forceinline__ long long block_scan(long long v,
                                                long long* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long w = s_warp[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long u = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += u;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const long long before = warp > 0 ? s_warp[warp - 1] : 0;
  __syncthreads();
  return v + before;
}

__global__ void __launch_bounds__(kTileThreads)
    bin_tiles_kernel(const BinFinishArgs a) {
  static_assert(kTileThreads == 1024, "one warp scans the warp totals");
  __shared__ long long s_warp[32];
  __shared__ long long s_carry;
  // tile t's segment starts at the first sorted pair of a tile >= t; the
  // padding past `take` and every invalid key count as tile T
  for (long long t = threadIdx.x; t <= a.n_tiles; t += kTileThreads)
    a.tile_offsets[t] =
        static_cast<int>(lower_bound(a.sorted_key, a.take, t << 32));
  if (threadIdx.x == 0) {
    const long long np = lower_bound(a.sorted_key, a.p, kInvalid);
    *a.num_pairs = static_cast<int>(np);
    *a.overflow_out = static_cast<int>(static_cast<long long>(
        *a.overflow + static_cast<unsigned long long>(max(np - a.pk, 0LL))));
    a.grad_offsets[0] = 0;
    s_carry = 0;
  }
  __syncthreads();
  // each tile's region [aligned floor of its offset, its end) rounded up
  // to whole align-wide windows, and their exclusive scan
  for (long long t0 = 0; t0 < a.n_tiles; t0 += kTileThreads) {
    const long long t = t0 + threadIdx.x;
    long long padded = 0, seg_base = 0;
    if (t < a.n_tiles) {
      const long long o0 = a.tile_offsets[t], o1 = a.tile_offsets[t + 1];
      seg_base = o0 / a.align * a.align;
      padded = (o0 - seg_base + (o1 - o0) + a.align - 1) / a.align * a.align;
    }
    const long long carry = s_carry;
    const long long end = carry + block_scan(padded, s_warp);
    if (t < a.n_tiles) {
      a.grad_offsets[t + 1] = static_cast<int>(end);
      a.shift[t] = static_cast<int>(end - padded - seg_base);
    }
    if (threadIdx.x == kTileThreads - 1) s_carry = end;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kSlotThreads)
    bin_slots_kernel(const BinFinishArgs a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kSlotThreads + threadIdx.x;
  if (i >= a.pk) return;
  int g = -1;
  if (i < a.take) {
    const long long key = a.sorted_key[i];
    if (key != kInvalid) {
      const long long flat = a.sorted_flat[i];
      const long long slot = i + a.shift[key >> 32];
      g = static_cast<int>(flat / a.cap);
      a.pair_slot[flat] = static_cast<int>(slot < a.pg - 1 ? slot : a.pg - 1);
    }
  }
  a.sorted_gauss[i] = g;
}

}  // namespace

// Launches the memset and bin_emit_kernel on `stream`: the keys, the
// pair-slot table filled with the spare slot, the spans, the overflow of
// the crop and the compaction. n >= 1.
extern "C" int bin_tiles_emit(const BinEmitArgs* a, void* stream) {
  if (a->n <= 0 || a->cap <= 0 || a->tile <= 0 || a->ntx <= 0 ||
      a->nty <= 0 || a->max_span <= 0 ||
      a->ntx * a->nty >= 0x7fffffffLL || a->n > 0x7fffffffLL / a->cap)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(a->overflow, 0, sizeof(long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  bin_emit_kernel<<<static_cast<unsigned>((a->n + kEmitThreads - 1) /
                                          kEmitThreads),
                    kEmitThreads, 0, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// Launches bin_tiles_kernel and bin_slots_kernel on `stream` over the
// keys sorted stably (sorted_key) and their flat (gaussian, slot) ids
// (sorted_flat).
extern "C" int bin_tiles_finish(const BinFinishArgs* a, void* stream) {
  if (a->p <= 0 || a->take < 0 || a->take > a->p || a->pk < a->take ||
      a->cap <= 0 || a->n_tiles <= 0 || a->align <= 0 ||
      a->pg > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bin_tiles_kernel<<<1, kTileThreads, 0, s>>>(*a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a->pk == 0) return static_cast<int>(err);
  bin_slots_kernel<<<static_cast<unsigned>((a->pk + kSlotThreads - 1) /
                                           kSlotThreads),
                     kSlotThreads, 0, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
