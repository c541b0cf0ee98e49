// The in-window prefix-sum micro-benchmark, for Hopper (sm_90a).
//
// Replaces the TPU kernel of scripts/exp_cumsum_kernel.py (run /
// make_kernel) and computes what it computes: for c = 0 .. steps - 1,
// la = x * (1 + c * 1e-9) over one (128, 256) block x, then the
// exclusive prefix sum of la down the 128 rows, summed over the rows
// and accumulated: out (256,) = sum_c sum_i excl_c[i, :]. The per-step
// factor keeps each step's work in the loop: every mode forms the whole
// (128, 256) exclusive-prefix block of every step its own way, then
// sums its rows.
//
// The TPU ran the experiment as one program on its whole chip; here
// `ctas` CTAs of 256 threads share the steps: CTA p sums the contiguous
// steps [steps p / ctas, steps (p + 1) / ctas) in order into its row of
// a (ctas, 256) partial buffer, and a second one-CTA kernel adds the
// rows in CTA order (chunk_scan_bench_plain(ctas=) adds in the same
// order). Each step's row sums are float32; the steps and the partials
// are accumulated in float64 and rounded once, so the result does not
// drift with the order of 4096 float32 additions (in a float32
// accumulator the kernel and its plain version, whose step sums differ
// in the last bits, drift apart by more than the check's 1e-5 at one
// CTA). ctas = the SM count fills the card; ctas = 1 gives the scan's
// cost inside one CTA, the figure the composite kernels' designers read
// (128 rows of 256 columns is one composite window: 128 pairs on 16 x 16
// pixels). Each CTA copies x (128 KB) into shared memory once with
// cp.async, as the TPU read x_ref once before its loop. Modes (0 tri,
// 1 cumsum, 2 shift, 3 tri3):
//   tri     excl = L la with the strictly lower 0/1 triangle L, on the
//           tensor cores: mma.sync m16n8k8 TF32 with f32 accumulation.
//           L is exact in TF32 and its A fragments are made in registers
//           from the indices; each la fragment is split into hi =
//           tf32(la) and lo = tf32(la - hi), two products whose sum is
//           la to ~2^-21 relative. Each warp owns 32 columns (4 n-tiles
//           of 8); per n-tile and k-block of 8 rows it loads and splits
//           la once and runs it against the 8 m-tiles of 16 rows, whose
//           blocks of L it keeps in registers. k-blocks that lie wholly
//           above the diagonal (zero in L) are skipped: 72 of the 128
//           (m, k) blocks remain. x sits in shared memory with a row
//           stride of 264 floats, so a B fragment's 32 loads hit 32
//           banks;
//   cumsum  a running sum down each thread's column: excl = incl - la,
//           as the TPU's cumsum(la) - la;
//   shift   Hillis-Steele: 7 masked shift-adds s += (i >= d ? s[i - d]
//           : 0), d = 1, 2, .., 64, then excl = s - la; one warp per
//           column, lane l holding rows 4l .. 4l + 3 in registers (x is
//           staged transposed, so those rows are one 16-byte load): d = 1
//           and 2 add within the lane's registers plus the previous
//           lane's last rows (one and two __shfl_up_sync), d = 4 .. 64
//           shift whole lanes (__shfl_up_sync by d / 4). The same
//           arithmetic as the TPU's masked rolls, with no block barrier
//           and no shared ping-pong;
//   tri3    L times the three payloads la, 2 la, 3 la (the TPU's one
//           (128, 128) @ (128, 768) product) on the tensor cores as in
//           tri, each payload split and accumulated on its own, the
//           three results summed per element.
//
// Bound on the H100: the function needs 4 fp32 operations per element
// and step (the scaled copy, the running sum, minus la, the row sum;
// tri and tri3 execute the triangle's 2 x 128 and 6 x 128 per element on
// the tensor cores, at up to 495 TFLOP/s in TF32), times 128 x 256 x
// steps, against 67 TFLOP/s for the card; x's 128 KB and the output are
// negligible. The design's aim is to use every SM (ctas) and, for the
// triangle modes, the tensor cores instead of one broadcast shared read
// per multiply-add.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;
constexpr int kCols = 256;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTriStride = kCols + 8;     // tri's x row stride in shared
constexpr int kShiftStride = kRows + 4;   // shift's x^T row stride

__device__ __forceinline__ float step_factor(int c) {
  return 1.0f + static_cast<float>(c) * 1e-9f;
}

// This CTA's steps [c0, c1).
__device__ __forceinline__ void step_range(int steps, int* c0, int* c1) {
  *c0 = static_cast<int>(static_cast<long long>(steps) * blockIdx.x /
                         gridDim.x);
  *c1 = static_cast<int>(static_cast<long long>(steps) * (blockIdx.x + 1) /
                         gridDim.x);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// x (kRows, kCols) into shared memory rows of `stride` floats with
// 16-byte cp.async copies, then a block barrier.
__device__ __forceinline__ void load_x(float* xs, const float* x,
                                       int stride) {
  for (int i = threadIdx.x; i < kRows * kCols / 4; i += kThreads) {
    const int r = i / (kCols / 4);
    const int q = 4 * (i - r * (kCols / 4));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(xs + r * stride + q)),
                 "l"(x + r * kCols + q));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ unsigned tf32(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// c += a b, one m16n8k8 TF32 tile, f32 accumulation.
__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int kPayloads>
__global__ void __launch_bounds__(kThreads, 1)
    tri_kernel(const float* __restrict__ x, double* __restrict__ part,
               int steps) {
  extern __shared__ float xs[];  // (kRows, kTriStride)
  load_x(xs, x, kTriStride);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // fragment thread in group
  constexpr unsigned kOne = 0x3f800000u;  // 1.0f, exact in TF32
  int c0, c1;
  step_range(steps, &c0, &c1);
  double acc[4][2] = {};
  for (int c = c0; c < c1; ++c) {
    const float f = step_factor(c);
#pragma unroll 1
    for (int ni = 0; ni < 4; ++ni) {
      const int n = warp * 32 + ni * 8 + g;  // this lane's B column
      float cc[kPayloads][8][4] = {};
#pragma unroll
      for (int kb = 0; kb < kRows / 8; ++kb) {
        const float la0 = xs[(8 * kb + t) * kTriStride + n] * f;
        const float la1 = xs[(8 * kb + t + 4) * kTriStride + n] * f;
        unsigned hi[kPayloads][2], lo[kPayloads][2];
#pragma unroll
        for (int q = 0; q < kPayloads; ++q) {
          const float p0 = q == 0 ? la0 : la0 * static_cast<float>(q + 1);
          const float p1 = q == 0 ? la1 : la1 * static_cast<float>(q + 1);
          hi[q][0] = tf32(p0);
          hi[q][1] = tf32(p1);
          lo[q][0] = tf32(p0 - __uint_as_float(hi[q][0]));
          lo[q][1] = tf32(p1 - __uint_as_float(hi[q][1]));
        }
#pragma unroll
        for (int mi = 0; mi < kRows / 16; ++mi) {
          if (8 * kb > 16 * mi + 15) continue;  // wholly above the diagonal
          // L[i][j] = j < i at i = 16 mi + row, j = 8 kb + col
          unsigned a[4];
          a[0] = (8 * kb + t < 16 * mi + g) ? kOne : 0u;
          a[1] = (8 * kb + t < 16 * mi + g + 8) ? kOne : 0u;
          a[2] = (8 * kb + t + 4 < 16 * mi + g) ? kOne : 0u;
          a[3] = (8 * kb + t + 4 < 16 * mi + g + 8) ? kOne : 0u;
#pragma unroll
          for (int q = 0; q < kPayloads; ++q) {
            mma_tf32(cc[q][mi], a, hi[q][0], hi[q][1]);
            mma_tf32(cc[q][mi], a, lo[q][0], lo[q][1]);
          }
        }
      }
      // the step's block of this n-tile is formed: sum its rows. This
      // lane holds rows g, g + 8 of every m-tile at columns 2t, 2t + 1.
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int mi = 0; mi < kRows / 16; ++mi) {
        float e[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          e[j] = cc[0][mi][j];
#pragma unroll
          for (int q = 1; q < kPayloads; ++q) e[j] += cc[q][mi][j];
        }
        s0 += e[0] + e[2];
        s1 += e[1] + e[3];
      }
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      acc[ni][0] += s0;
      acc[ni][1] += s1;
    }
  }
  if (g == 0) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      double* o = part + blockIdx.x * kCols + warp * 32 + ni * 8 + 2 * t;
      o[0] = acc[ni][0];
      o[1] = acc[ni][1];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    cumsum_kernel(const float* __restrict__ x, double* __restrict__ part,
                  int steps) {
  extern __shared__ float xs[];  // (kRows, kCols)
  load_x(xs, x, kCols);
  const int col = threadIdx.x;
  int c0, c1;
  step_range(steps, &c0, &c1);
  double acc = 0.0;
  for (int c = c0; c < c1; ++c) {
    const float f = step_factor(c);
    float incl = 0.0f, colsum = 0.0f;
    for (int j = 0; j < kRows; ++j) {
      const float l = xs[j * kCols + col] * f;
      incl += l;
      colsum += incl - l;
    }
    acc += colsum;
  }
  part[blockIdx.x * kCols + col] = acc;
}

__global__ void __launch_bounds__(kThreads, 1)
    shift_kernel(const float* __restrict__ x, double* __restrict__ part,
                 int steps) {
  extern __shared__ float xt[];  // (kCols, kShiftStride): x transposed
  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    const int r = i / kCols;
    const int col = i - r * kCols;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(xt + col * kShiftStride + r)),
                 "l"(x + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const unsigned full = 0xffffffffu;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int c0, c1;
  step_range(steps, &c0, &c1);
  double acc = 0.0;  // column warp * 32 + lane
  for (int c = c0; c < c1; ++c) {
    const float f = step_factor(c);
    for (int m = 0; m < 32; ++m) {
      const int col = warp * 32 + m;
      const float4 v = *reinterpret_cast<const float4*>(
          xt + col * kShiftStride + 4 * lane);
      const float la[4] = {v.x * f, v.y * f, v.z * f, v.w * f};
      float s[4] = {la[0], la[1], la[2], la[3]};
      // d = 1: row 4 lane + q adds row 4 lane + q - 1
      float p3 = __shfl_up_sync(full, s[3], 1);
      s[3] += s[2];
      s[2] += s[1];
      s[1] += s[0];
      s[0] += lane >= 1 ? p3 : 0.0f;
      // d = 2
      const float p2 = __shfl_up_sync(full, s[2], 1);
      p3 = __shfl_up_sync(full, s[3], 1);
      s[3] += s[1];
      s[2] += s[0];
      s[1] += lane >= 1 ? p3 : 0.0f;
      s[0] += lane >= 1 ? p2 : 0.0f;
      // d = 4 .. 64: whole lanes, d / 4 apart
#pragma unroll
      for (int dl = 1; dl < 32; dl *= 2) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float u = __shfl_up_sync(full, s[q], dl);
          s[q] += lane >= dl ? u : 0.0f;
        }
      }
      float colsum = (s[0] - la[0]) + (s[1] - la[1]) + (s[2] - la[2]) +
                     (s[3] - la[3]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        colsum += __shfl_xor_sync(full, colsum, off);
      if (lane == m) acc += colsum;
    }
  }
  part[blockIdx.x * kCols + warp * 32 + lane] = acc;
}

// out[col] = the sum of the ctas partial rows in CTA order, in float64,
// rounded once.
__global__ void sum_partials(const double* __restrict__ part,
                             float* __restrict__ out, int ctas) {
  const int col = threadIdx.x;
  double s = 0.0;
  for (int p = 0; p < ctas; ++p) s += part[p * kCols + col];
  out[col] = static_cast<float>(s);
}

template <typename K>
int launch(K kernel, size_t smem, const float* x, double* part, int steps,
           int ctas, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<ctas, kThreads, smem, stream>>>(x, part, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (128, 256) f32 contiguous and 16-byte aligned, part (ctas, 256) f64
// scratch, out (256,) f32; `ctas` CTAs, then the partials' sum, on
// `stream`. Returns the first CUDA error of the launches.
extern "C" int chunk_scan_bench_launch(const float* x, double* part,
                                       float* out, int steps, int mode,
                                       int ctas, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ctas <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t tri_smem = sizeof(float) * kRows * kTriStride;
  int err;
  switch (mode) {
    case 0:
      err = launch(tri_kernel<1>, tri_smem, x, part, steps, ctas, s);
      break;
    case 1:
      err = launch(cumsum_kernel, sizeof(float) * kRows * kCols, x, part,
                   steps, ctas, s);
      break;
    case 2:
      err = launch(shift_kernel, sizeof(float) * kCols * kShiftStride, x,
                   part, steps, ctas, s);
      break;
    case 3:
      err = launch(tri_kernel<3>, tri_smem, x, part, steps, ctas, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  sum_partials<<<1, kCols, 0, s>>>(part, out, ctas);
  return static_cast<int>(cudaGetLastError());
}
