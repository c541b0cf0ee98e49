// The in-window prefix-sum micro-benchmark, for Hopper (sm_90a).
//
// Replaces the TPU kernel of scripts/exp_cumsum_kernel.py (run /
// make_kernel) and computes what it computes: for c = 0 .. steps - 1,
// la = x * (1 + c * 1e-9) over one (128, 256) block x, then the
// exclusive prefix sum of la down the 128 rows, summed over the rows
// and accumulated: out (256,) = sum_c sum_i excl_c[i, :]. The per-step
// factor keeps each step's work in the loop.
//
// One CTA of 256 threads runs the whole block, as the TPU ran one
// program: 128 rows of 256 columns is the shape of one composite
// window (128 pairs on 16 x 16 pixels), so a step's time reads as the
// scan's cost inside one composite CTA. Each mode does its own
// arithmetic (mode: 0 tri, 1 cumsum, 2 shift, 3 tri3):
//   tri     excl = L la with the strictly lower 0/1 triangle L (64 KB)
//           held in shared memory; la (128 KB) written to shared memory
//           once a step, each thread its own column; each thread forms
//           its column's 128 row sums of all 128 products, 16 rows at a
//           time in registers;
//   cumsum  a running sum down each thread's column: excl = incl - la,
//           as the TPU's cumsum(la) - la;
//   shift   Hillis-Steele: 7 passes s += (i >= d ? s[i - d] : 0) for
//           d = 1, 2, .., 64 over a (128, 128) half of the block,
//           ping-pong between two shared buffers (2 x 64 KB) with a
//           block barrier between passes (two threads share a column,
//           on alternate rows, and join their sums once a step), then
//           excl = s - la;
//   tri3    L times the three payloads la, 2 la, 3 la (the TPU's one
//           (128, 128) @ (128, 768) product), summed: the (128, 768)
//           payload does not fit beside L and la, so the payloads are
//           formed from la and streamed through registers.
// x (128 KB) is read through the L1/L2 caches, once a step.
//
// Bound on the H100: operations per element and step, 258 (tri: la 1,
// 128 multiply-adds 256, the row sum 1), 4 (cumsum), 17 (shift: la 1, 7
// masked adds 14, the difference 1, the row sum 1), 774 (tri3: la and
// the two payloads 3, 3 x 128 multiply-adds 768, 2 to sum them, the row
// sum 1), times 128 x 256 x steps, against ONE SM's share of the
// card's fp32 rate (67 TFLOP/s / 132): the kernel is one CTA. The
// bytes (x once, out once) are negligible.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;
constexpr int kCols = 256;
constexpr int kHalf = kCols / 2;
constexpr int kBlock = 16;  // rows of a triangle product in registers

__device__ __forceinline__ float step_factor(int c) {
  return 1.0f + static_cast<float>(c) * 1e-9f;
}

template <int kPayloads>
__global__ void __launch_bounds__(kCols, 1)
    tri_kernel(const float* __restrict__ x, float* __restrict__ out,
               int steps) {
  extern __shared__ float smem[];
  float* tri = smem;                 // (kRows, kRows)
  float* la = smem + kRows * kRows;  // (kRows, kCols)
  const int col = threadIdx.x;
  for (int i = threadIdx.x; i < kRows * kRows; i += blockDim.x)
    tri[i] = (i % kRows) < (i / kRows) ? 1.0f : 0.0f;
  __syncthreads();
  float acc = 0.0f;
  for (int c = 0; c < steps; ++c) {
    const float f = step_factor(c);
    // each thread reads back only its own column: no barrier needed
    for (int j = 0; j < kRows; ++j)
      la[j * kCols + col] = __ldg(&x[j * kCols + col]) * f;
    float colsum = 0.0f;
    for (int i0 = 0; i0 < kRows; i0 += kBlock) {
      float s[kPayloads][kBlock];
#pragma unroll
      for (int q = 0; q < kPayloads; ++q)
#pragma unroll
        for (int ii = 0; ii < kBlock; ++ii) s[q][ii] = 0.0f;
      for (int j = 0; j < kRows; ++j) {
        float p[kPayloads];
        p[0] = la[j * kCols + col];
        if constexpr (kPayloads == 3) {
          p[1] = p[0] * 2.0f;
          p[2] = p[0] * 3.0f;
        }
#pragma unroll
        for (int ii = 0; ii < kBlock; ++ii) {
          const float t = tri[(i0 + ii) * kRows + j];  // broadcast read
#pragma unroll
          for (int q = 0; q < kPayloads; ++q) s[q][ii] += t * p[q];
        }
      }
#pragma unroll
      for (int ii = 0; ii < kBlock; ++ii) {
        float excl = s[0][ii];
        if constexpr (kPayloads == 3) excl = excl + s[1][ii] + s[2][ii];
        colsum += excl;
      }
    }
    acc += colsum;
  }
  out[col] = acc;
}

__global__ void __launch_bounds__(kCols, 1)
    cumsum_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int steps) {
  const int col = threadIdx.x;
  float acc = 0.0f;
  for (int c = 0; c < steps; ++c) {
    const float f = step_factor(c);
    float incl = 0.0f, colsum = 0.0f;
    for (int j = 0; j < kRows; ++j) {
      const float l = __ldg(&x[j * kCols + col]) * f;
      incl += l;
      colsum += incl - l;
    }
    acc += colsum;
  }
  out[col] = acc;
}

__global__ void __launch_bounds__(kCols, 1)
    shift_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int steps) {
  extern __shared__ float smem[];
  float* buf0 = smem;                  // (kRows, kHalf)
  float* buf1 = smem + kRows * kHalf;  // (kRows, kHalf)
  float* odd = smem + 2 * kRows * kHalf;  // (kHalf,) odd rows' sums
  const int cih = threadIdx.x % kHalf;  // column within the half
  const int par = threadIdx.x / kHalf;  // this thread's rows: par, par + 2..
  float acc[2] = {0.0f, 0.0f};  // kept by the even-row thread
  for (int c = 0; c < steps; ++c) {
    const float f = step_factor(c);
    for (int h = 0; h < 2; ++h) {
      const int col = h * kHalf + cih;
      for (int r = par; r < kRows; r += 2)
        buf0[r * kHalf + cih] = __ldg(&x[r * kCols + col]) * f;
      __syncthreads();
      float* src = buf0;
      float* dst = buf1;
      for (int d = 1; d < kRows; d *= 2) {
        for (int r = par; r < kRows; r += 2)
          dst[r * kHalf + cih] =
              src[r * kHalf + cih] + (r >= d ? src[(r - d) * kHalf + cih]
                                             : 0.0f);
        __syncthreads();
        float* t = src;
        src = dst;
        dst = t;
      }
      float colsum = 0.0f;
      for (int r = par; r < kRows; r += 2)
        colsum += src[r * kHalf + cih] - __ldg(&x[r * kCols + col]) * f;
      // the column's two threads: its step sum joins the accumulator
      // once, as in the other modes; the barrier also keeps src (the
      // next half's dst) until every thread has read it
      if (par == 1) odd[cih] = colsum;
      __syncthreads();
      if (par == 0) acc[h] += colsum + odd[cih];
    }
  }
  if (par == 0) {
    out[cih] = acc[0];
    out[kHalf + cih] = acc[1];
  }
}

template <typename K>
int launch(K kernel, size_t smem, const float* x, float* out, int steps,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<1, kCols, smem, stream>>>(x, out, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (128, 256) f32 contiguous, out (256,) f32; one CTA on `stream`.
// Returns cudaGetLastError() of the launch.
extern "C" int chunk_scan_bench_launch(const float* x, float* out, int steps,
                                       int mode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t tri_smem = sizeof(float) * (kRows * kRows + kRows * kCols);
  switch (mode) {
    case 0:
      return launch(tri_kernel<1>, tri_smem, x, out, steps, s);
    case 1:
      return launch(cumsum_kernel, 0, x, out, steps, s);
    case 2:
      return launch(shift_kernel, sizeof(float) * (2 * kRows + 1) * kHalf, x,
                    out, steps, s);
    case 3:
      return launch(tri_kernel<3>, tri_smem, x, out, steps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
