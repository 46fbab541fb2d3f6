// Jacobi sweep kernels for Hopper (sm_90a), with a plain C interface.
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/jacobi_sweep/kernel.py:
//
// * `jacobi_sweep_kernel` (body `_jacobi_kernel`), the plain sweep
//     x' = (b − A·x + d·x) / d
// * `jacobi_sweep_residual_kernel` (body `_jacobi_fused_kernel`), the
//   fused-residual sweep: one pass over A gives
//     r = b − A·x,   x' = x + r / d,   and Σ r² per block of rows.
//
// A (N, N) row-major in fp32 or bf16; x, b and d (N,) each in fp32 or bf16;
// the products accumulate in fp32 and x' comes out in x's dtype.  The
// per-block partials of Σ r² are fp32; the caller sums them (deterministic:
// each partial has a fixed order, and there are no atomics).
//
// Design.  The function is a matrix-vector product with a fused epilogue:
// each element of A is used once, so it is bound by the bytes of A
// (N²·elt(A), 208 MB in fp32 at N 7209: 62 µs at 3.35 TB/s), not by its
// 2N² operations.  The TPU kernel walks (row block, column block) tiles in
// order with a VMEM accumulator; here blocks run in parallel and nothing
// carries between them, so each block owns whole rows and walks all of
// their columns itself.  A block is 8 warps; each warp owns two rows and
// reads them with coalesced 4-byte (fp32) or 2-byte (bf16) loads, lane i
// taking columns i, i + 32, i + 64, ..., four column steps unrolled so
// that 8 loads of A are in flight per lane.  x is read through the
// read-only cache (every warp of the block reads it; it stays in L1).  A
// shuffle reduction gives each row's A·x; lane 0 forms x' (and r²), and
// the block sums its warps' r² in order into partials[block].
//
// Every N works: no alignment is assumed (at the paper's odd N most rows
// of A start off a 16-byte boundary, so there are no vector loads), the
// column tail is a scalar loop, and rows past N are clamped to row N − 1
// for their loads and never stored, so N = 1 and ragged N need no
// padding (the TPU wrapper pads A to the block lcm, which copies all of A
// on every call).  Wider loads after a scalar head, x staged in shared
// memory and a split over columns for small N are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libjacobi_sweep.so jacobi_sweep.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// b and d are read once per row, so their dtype is a run-time flag.
__device__ __forceinline__ float load_vec(const void* p, int i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

template <typename TA, typename TX, bool kFused>
__global__ void __launch_bounds__(kThreads)
    jacobi_sweep_kernel(const TA* __restrict__ A, const TX* __restrict__ x,
                        const void* __restrict__ b,
                        const void* __restrict__ d, TX* __restrict__ out,
                        float* __restrict__ partials, int n, int b_bf16,
                        int d_bf16) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;

  const TA* arow[kRowsPerWarp];
  float acc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = min(row0 + r, n - 1);  // clamped: loaded, never stored
    arow[r] = A + static_cast<size_t>(row) * n;
    acc[r] = 0.f;
  }

  int c = lane;
  for (; c + 32 * (kUnroll - 1) < n; c += 32 * kUnroll) {
    float xv[kUnroll];
    float av[kRowsPerWarp][kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) xv[u] = to_f32(__ldg(x + c + 32 * u));
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        av[r][u] = to_f32(__ldg(arow[r] + c + 32 * u));
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc[r] = fmaf(av[r][u], xv[u], acc[r]);
  }
  for (; c < n; c += 32) {
    const float xv = to_f32(__ldg(x + c));
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      acc[r] = fmaf(to_f32(__ldg(arow[r] + c)), xv, acc[r]);
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);

  float rsq = 0.f;
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
      if (row >= n) break;
      const float bi = load_vec(b, row, b_bf16);
      const float di = load_vec(d, row, d_bf16);
      const float xi = to_f32(x[row]);
      if (kFused) {
        const float res = bi - acc[r];
        out[row] = from_f32<TX>(xi + res / di);
        rsq = fmaf(res, res, rsq);
      } else {
        out[row] = from_f32<TX>((bi - acc[r] + di * xi) / di);
      }
    }
  }

  if (kFused) {
    __shared__ float warp_rsq[kWarps];
    if (lane == 0) warp_rsq[warp] = rsq;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += warp_rsq[w];
      partials[blockIdx.x] = s;
    }
  }
}

template <typename TA, typename TX>
void launch(const void* A, const void* x, const void* b, const void* d,
            void* out, void* partials, int n, int b_bf16, int d_bf16,
            int fused, cudaStream_t stream) {
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock);
  if (fused) {
    jacobi_sweep_kernel<TA, TX, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const TA*>(A), static_cast<const TX*>(x), b, d,
        static_cast<TX*>(out), static_cast<float*>(partials), n, b_bf16,
        d_bf16);
  } else {
    jacobi_sweep_kernel<TA, TX, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const TA*>(A), static_cast<const TX*>(x), b, d,
        static_cast<TX*>(out), nullptr, n, b_bf16, d_bf16);
  }
}

}  // namespace

extern "C" {

// Number of row blocks (and of fused partials) for size n.
int jacobi_sweep_n_blocks(int n) {
  return (n + kRowsPerBlock - 1) / kRowsPerBlock;
}

// A (n, n), x, b, d, out (n,) device arrays, each fp32 or bf16 as its flag
// says (out has x's dtype); partials (jacobi_sweep_n_blocks(n),) fp32, used
// only when fused.  Returns the cudaError_t of the launch (0 on success).
int jacobi_sweep_launch(const void* A, const void* x, const void* b,
                        const void* d, void* out, void* partials, int n,
                        int a_bf16, int x_bf16, int b_bf16, int d_bf16,
                        int fused, void* stream) {
  if (n <= 0 || (fused && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_bf16 && x_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(A, x, b, d, out, partials, n, b_bf16,
                                         d_bf16, fused, s);
  else if (a_bf16)
    launch<__nv_bfloat16, float>(A, x, b, d, out, partials, n, b_bf16, d_bf16,
                                 fused, s);
  else if (x_bf16)
    launch<float, __nv_bfloat16>(A, x, b, d, out, partials, n, b_bf16, d_bf16,
                                 fused, s);
  else
    launch<float, float>(A, x, b, d, out, partials, n, b_bf16, d_bf16, fused,
                         s);
  return (int)cudaGetLastError();
}

const char* jacobi_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
