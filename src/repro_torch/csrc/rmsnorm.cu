// RMSNorm kernel for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/rmsnorm/kernel.py,
// `rmsnorm_kernel` (body `_rmsnorm_kernel`): for every row of x2d (R, d)
//     out = x · rsqrt(mean(x²) + eps) · g
// with fp32 accumulation; x and out fp32 or bf16 (out in x's dtype), the
// gain g (d,) fp32.
//
// Design.  The function does 4 operations per element against 2·elt(x)
// bytes of traffic (x read once, out written once), so it is bound by
// bytes: 33.5 MB at (4096, 1024) fp32, 10 µs at 3.35 TB/s.  The TPU kernel
// holds a (rows × d) tile in VMEM and reduces it in one pass; here one
// warp owns one row and `row_block` warps (a launch argument, tuned by
// the port's autotuner) make a block.  Pass 1: each lane sums the squares
// of its share of the row in fp32, with 16-byte vector loads (4 fp32 or
// 8 bf16 values) when d and the three pointers allow it and scalar loads
// otherwise; a butterfly of warp shuffles gives every lane the row's sum.
// Pass 2 reads the row again (at most 64 KB, d 16384 in fp32: it comes
// from L1 or L2, not device memory), scales it and writes it in x's dtype.
// The multiplications keep the reference's order, (x · r) · g.
//
// Rows past R are masked (the warp returns), so ragged R needs no padding:
// the TPU wrapper pads R to a multiple of 8, the sublane, and slices the
// result, which copies x and out once more.  Keeping the row in registers
// between the passes, and several rows a warp for small d, are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librmsnorm.so rmsnorm.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxRowBlock = 32;  // 1,024 threads a block

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

// 16 bytes of T: 4 fp32 or 8 bf16 values.
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
};

__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint4 t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = t;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxRowBlock * 32)
    rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ g,
                   T* __restrict__ out, int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // the ragged last block: whole warps leave
  const T* xr = x + row * d;
  T* orow = out + row * d;
  constexpr int kN = Vec<T>::kN;

  float ss = 0.f;
  if (kVec) {
    const int nv = d / kN;
#pragma unroll 4
    for (int i = lane; i < nv; i += 32) {
      float v[kN];
      load_vec(xr + static_cast<size_t>(i) * kN, v);
#pragma unroll
      for (int j = 0; j < kN; ++j) ss = fmaf(v[j], v[j], ss);
    }
  } else {
#pragma unroll 4
    for (int i = lane; i < d; i += 32) {
      const float v = to_f32(xr[i]);
      ss = fmaf(v, v, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  if (kVec) {
    const int nv = d / kN;
#pragma unroll 4
    for (int i = lane; i < nv; i += 32) {
      float v[kN], gv[kN];
      load_vec(xr + static_cast<size_t>(i) * kN, v);
#pragma unroll
      for (int j = 0; j < kN; j += 4) load_vec(g + i * kN + j, gv + j);
#pragma unroll
      for (int j = 0; j < kN; ++j) v[j] = (v[j] * r) * gv[j];
      store_vec(orow + static_cast<size_t>(i) * kN, v);
    }
  } else {
#pragma unroll 4
    for (int i = lane; i < d; i += 32)
      orow[i] = from_f32<T>((to_f32(xr[i]) * r) * __ldg(g + i));
  }
}

template <typename T>
void launch(const void* x, const void* g, void* out, int rows, int d,
            float eps, int row_block, cudaStream_t stream) {
  const bool vec =
      d % Vec<T>::kN == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
        reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const dim3 grid((rows + row_block - 1) / row_block);
  const dim3 block(row_block * 32);
  if (vec)
    rmsnorm_kernel<T, true><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(g),
        static_cast<T*>(out), rows, d, eps);
  else
    rmsnorm_kernel<T, false><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(g),
        static_cast<T*>(out), rows, d, eps);
}

}  // namespace

extern "C" {

// x, out (rows, d) row-major device arrays, both fp32 or both bf16 as
// x_bf16 says; g (d,) fp32.  row_block: rows (warps) a block, 1..32.
// Returns the cudaError_t of the launch (0 on success).
int rmsnorm_launch(const void* x, const void* g, void* out, int rows, int d,
                   float eps, int row_block, int x_bf16, void* stream) {
  if (rows <= 0 || d <= 0 || row_block < 1 || row_block > kMaxRowBlock)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    launch<__nv_bfloat16>(x, g, out, rows, d, eps, row_block, s);
  else
    launch<float>(x, g, out, rows, d, eps, row_block, s);
  return (int)cudaGetLastError();
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
