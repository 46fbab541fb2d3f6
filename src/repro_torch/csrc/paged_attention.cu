// Paged flash-decode attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel `paged_attention_kernel` (body
// `_paged_kernel`) of src/repro/kernels/paged_attention/kernel.py: one query
// token per slot attends over that slot's K/V pages in place in the shared
// pool (P, KV, page_size, D), resolving logical page j of slot b to
// physical page pages[b, j] inside the kernel.  It emits the unnormalised
// fp32 accumulator and the running max / denominator; the wrapper
// (kernels/paged_attention/ops.py) merges the current token's own K/V.
//
// Design.  One block per (slot b, kv head h) holds all G = H/KV query rows
// of that head.  The sequential page axis of the Pallas grid becomes a loop
// over logical pages inside the block; the running m, l and acc stay in
// shared memory in fp32.  The block reads pid = pages[b, j] itself (this
// takes the place of scalar prefetch) and stages that page's K and V rows
// into shared memory, converted to fp32.  Pages that cannot hold a valid
// position are skipped exactly as the Pallas kernel skips them: j*ps >=
// kv_len, or, with a window, (j+1)*ps - 1 < kv_len + 1 - window.  Inside a
// page, positions >= kv_len (and, with a window, < kv_len + 1 - window)
// score NEG_INF, not -inf, so every exp stays finite as in the reference.
// Physical page 0 is the trash page: its contents may be NaN, so it is read
// as zeros by select (pid == 0 ? 0 : load), never by a product with 0.
// Scores and p stay in fp32 before the PV product, as in the Pallas kernel.
//
// Bound.  The kernel is bound by the K/V page bytes it reads: it does
// 4*G*D flops per K/V row of 2*D elements, far below the card's
// flops-per-byte balance point.  With qwen2-1.5b's KV = 2 it launches only
// 2*B blocks, too few for the card's 132 SMs; splitting the page loop
// across blocks (split-K flash-decode, with a second merge pass) and
// pipelining the page loads (cp.async / TMA) are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared-memory floats the kernel needs; rows of q and K are padded to
// D + 1 so that the score loop (one thread per (g, t) pair, walking d)
// reads distinct banks.
__host__ __device__ inline size_t smem_floats(int G, int D, int ps) {
  return (size_t)G * (D + 1)     // q rows
         + (size_t)ps * (D + 1)  // K page
         + (size_t)ps * D        // V page
         + (size_t)G * ps        // scores, then p
         + (size_t)G * D         // acc
         + 3 * (size_t)G;        // m, l, per-page correction
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ pages,
                       const int32_t* __restrict__ kv_len,
                       float* __restrict__ acc_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int KV, int G, int D,
                       int ps, int n_pages, int window) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int rs = D + 1;  // padded row stride of q and K

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + (size_t)G * rs;
  float* v_s = k_s + (size_t)ps * rs;
  float* p_s = v_s + (size_t)ps * D;
  float* acc_s = p_s + (size_t)G * ps;
  float* m_s = acc_s + (size_t)G * D;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const int len = kv_len[b];
  const size_t bh = (size_t)b * KV + h;
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    q_s[g * rs + d] = to_f32(q[bh * G * D + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  // pages with j*ps < kv_len; later pages hold no valid position
  const int n_run = min(n_pages, (len + ps - 1) / ps);
  for (int j = 0; j < n_run; ++j) {
    if (window > 0 && (j + 1) * ps - 1 < len + 1 - window) continue;
    const int pid = pages[(size_t)b * n_pages + j];
    __syncthreads();  // the previous page's shared-memory reads are done

    const size_t base = ((size_t)pid * KV + h) * ps * D;
    for (int i = tid; i < ps * D; i += blockDim.x) {
      const int t = i / D, d = i - t * D;
      float kx = 0.f, vx = 0.f;
      if (pid != 0) {  // trash page: zeros by select
        kx = to_f32(k_pool[base + i]);
        vx = to_f32(v_pool[base + i]);
      }
      k_s[t * rs + d] = kx;
      v_s[i] = vx;
    }
    __syncthreads();

    for (int i = tid; i < G * ps; i += blockDim.x) {
      const int g = i / ps, t = i - g * ps;
      const int pos = j * ps + t;
      const bool ok = pos < len && (window <= 0 || pos >= len + 1 - window);
      const float* qr = q_s + g * rs;
      const float* kr = k_s + t * rs;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[i] = ok ? s : kNegInf;
    }
    __syncthreads();

    // online-softmax update: one warp per query row
    for (int g = warp; g < G; g += n_warps) {
      float* pr = p_s + g * ps;
      const float m_prev = m_s[g];
      float mx = kNegInf;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, pr[t]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i - g * D;
      const float* pr = p_s + g * ps;
      float a = 0.f;
      for (int t = 0; t < ps; ++t) a = fmaf(pr[t], v_s[t * D + d], a);
      acc_s[i] = acc_s[i] * c_s[g] + a;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += blockDim.x) acc_out[bh * G * D + i] = acc_s[i];
  for (int g = tid; g < G; g += blockDim.x) {
    m_out[bh * G + g] = m_s[g];
    l_out[bh * G + g] = l_s[g];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* pages, const void* kv_len, void* acc, void* m,
                   void* l, int B, int KV, int G, int D, int ps, int n_pages,
                   int window, cudaStream_t stream) {
  const size_t smem = smem_floats(G, D, ps) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  paged_attention_kernel<T><<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(pages),
      static_cast<const int32_t*>(kv_len), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), KV, G, D, ps, n_pages,
      window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q and both pools).  window <= 0: none.
// Returns the cudaError_t of the launch (0 on success).
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* pages,
                           const void* kv_len, void* acc, void* m, void* l,
                           int B, int KV, int G, int D, int ps, int n_pages,
                           int window, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || KV <= 0 || G <= 0 || D <= 0 || ps <= 0 || n_pages <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(q, k_pool, v_pool, pages, kv_len, acc, m, l, B,
                              KV, G, D, ps, n_pages, window, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k_pool, v_pool, pages, kv_len, acc,
                                      m, l, B, KV, G, D, ps, n_pages, window,
                                      s);
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
