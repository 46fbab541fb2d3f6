// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces the Pallas TPU kernel `ssd_intra_chunk_kernel` (body
// `_ssd_kernel`) of src/repro/kernels/ssd_scan/kernel.py.  Per (batch·chunk
// bc, head h), over the chunk's Q positions:
//
//   cum = cumsum(a)                               (Q,)
//   y   = ((C Bᵀ) ⊙ tril(exp(cum_t − cum_s))) (dt ⊙ x)   (Q, P)
//   S   = (B ⊙ dt ⊙ exp(cum_end − cum))ᵀ x                (N, P)
//
// with x (BC, H, Q, P), dt and a (BC, H, Q, 1), B and C (BC, Q, N) shared by
// the heads, all fp32; y (BC, H, Q, P) and S (BC, H, N, P) come out fp32.
// The inter-chunk recurrence stays in PyTorch (models/ssm.py ssd_chunked).
//
// Design.  The TPU kernel holds the whole (Q, Q) score matrix of a head in
// VMEM; at Q = 256 that is 256 KB, more than a Hopper block's 227 KB of
// shared memory, and its (BC, H) grid is only 32 blocks at the serving
// shape for 132 SMs.  Here one launch runs two kinds of 256-thread blocks,
// grid (n_y_tiles + n_s_tiles, H, BC):
//
// * y blocks own 64 rows t and 64 columns p of y.  They walk the column
//   tiles s <= t in steps of 64; per tile they form C Bᵀ in registers from
//   32-deep chunks of C and B staged in shared memory, weight it by
//   exp(cum_t − cum_s)·dt_s where s <= t (a select, so the exp above the
//   diagonal, which may overflow, is never evaluated), stage that 64 × 64
//   tile of M in shared memory and accumulate M (dt ⊙ x) for their rows.
// * S blocks own 64 rows n and 64 columns p of S, a reduction over all Q
//   positions in steps of 32.
//
// Every thread keeps a 4 × 4 register tile of its block's 64 × 64 output
// (rows 4ty + i, columns 4tx + j).  Operands sit in shared memory with the
// thread's four rows, and its four columns, side by side (C, B and M
// transposed, depth-major), so each step of an inner loop is two 16-byte
// loads for sixteen FMAs.  Rows, columns and depths past Q, P and N are
// masked to zeros at the loads and not stored, so any Q >= 1 (the serving
// buckets 16..256, the CPU tests' 8) and any P, N work.  Every block
// stages a and dt in shared memory and computes cum itself, one warp over
// Q: each lane sums a contiguous segment, an exclusive warp scan
// (shuffles) offsets the segments, and each lane then adds its segment
// one element at a time.  The order differs from torch.cumsum's,
// so kernel and plain version disagree by a few ulp of |cum| (stated in
// chip_smoke.py).  Arithmetic is fp32 FMA on the CUDA cores: no TF32.
//
// Bound.  At the serving shape (BC 1, H 32, Q 256, P 64, N 128) the
// function moves about 5.6 MB (1.7 µs at 3.35 TB/s) and needs about 0.28
// GFLOP counting C Bᵀ once per chunk and only the causal half (4.2 µs at
// 67 TFLOP/s fp32): it is bound by operations.  This kernel recomputes
// C Bᵀ in every head's blocks (32 times; it is shared by the heads) and
// over the whole diagonal tile, roughly doubling the operations.  What
// limits it in practice is latency: its 192 blocks fill one wave, and
// the blocks of the last row tile walk four column tiles, each four
// rounds of load, barrier and compute.  The staging loops have fixed trip
// counts, so each round's loads are in flight together, and each column
// tile's x tile is loaded ahead of its C Bᵀ rounds.  Double-buffered staging,
// splitting the column walk across blocks, sharing C Bᵀ across heads and
// the tensor cores (wgmma, which needs TF32 or a split-precision product
// to keep fp32 accuracy) are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssd_scan.so ssd_scan.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTile = 64;          // rows and columns of an output tile
constexpr int kDepth = 32;         // depth of one staged chunk
constexpr int kStride = kTile + 4; // rows stay 16-byte aligned; padded so
                                   // the transposing stores spread banks
// the C and B chunks of the y blocks; the M tile aliases them, and the S
// blocks' weighted-B and x chunks fit in the same floats
constexpr int kRegion = 2 * kDepth * kStride;
static_assert(kRegion >= kTile * kStride, "M tile must fit the C/B region");
static_assert(kRegion >= 2 * kDepth * kTile, "S chunks must fit the region");
static_assert(kTile * kDepth % kThreads == 0, "staging loops have no tail");

__host__ __device__ inline size_t smem_floats(int Q) {
  return (size_t)kRegion + (size_t)kTile * kTile + 2 * (size_t)Q;
}

// In place: cum[0..Q) holds a on entry and its inclusive prefix sums on
// exit; called by warp 0 only.
__device__ void warp_cumsum(float* cum, int Q) {
  const int lane = threadIdx.x & 31;
  const int seg = (Q + 31) / 32;
  const int lo = min(lane * seg, Q);
  const int hi = min(lo + seg, Q);
  float tot = 0.f;
  for (int e = lo; e < hi; ++e) tot += cum[e];
  float incl = tot;
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = 0.f;
  for (int e = lo; e < hi; ++e) {
    run += cum[e];
    cum[e] = run;
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ a,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm, float* __restrict__ y,
                       float* __restrict__ S, int H, int Q, int P, int N,
                       int n_y_tiles) {
  const int h = blockIdx.y;
  const int bc = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  extern __shared__ float4 smem4[];  // float4: 16-byte aligned
  float* region = reinterpret_cast<float*>(smem4);
  float* x_s = region + kRegion;
  float* cum_s = x_s + kTile * kTile;
  float* dt_s = cum_s + Q;

  const size_t bh = (size_t)bc * H + h;
  const float* xg = x + bh * Q * P;
  const float* Bg = Bm + (size_t)bc * Q * N;
  const float* Cg = Cm + (size_t)bc * Q * N;

  // a and dt staged by every thread, coalesced; then one warp scans a
  for (int i = tid; i < Q; i += kThreads) {
    cum_s[i] = a[bh * Q + i];
    dt_s[i] = dt[bh * Q + i];
  }
  __syncthreads();
  if (tid < 32) warp_cumsum(cum_s, Q);
  __syncthreads();

  const int n_p_tiles = (P + kTile - 1) / kTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if ((int)blockIdx.x < n_y_tiles) {
    // ---- y rows [t0, t0 + 64), columns [p0, p0 + 64) -------------------
    const int t0 = (blockIdx.x / n_p_tiles) * kTile;
    const int p0 = (blockIdx.x % n_p_tiles) * kTile;
    float* c_s = region;                     // [depth][row t]
    float* b_s = region + kDepth * kStride;  // [depth][column s]
    float* m_s = region;                     // [column s][row t]
    const int s_end = min(t0 + kTile, Q);
    for (int s0 = 0; s0 < s_end; s0 += kTile) {
      // the x tile has a buffer of its own: load it first, so its latency
      // hides behind the C Bᵀ loop (the loop's first barrier publishes it)
#pragma unroll
      for (int it = 0; it < kTile * kTile / kThreads; ++it) {
        const int i = tid + it * kThreads;
        const int r = i / kTile;
        const int pp = i - r * kTile;
        const int sr = s0 + r;
        const int p = p0 + pp;
        x_s[i] = (sr < Q && p < P) ? xg[(size_t)sr * P + p] : 0.f;
      }
      float cb[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cb[i][j] = 0.f;
      for (int k0 = 0; k0 < N; k0 += kDepth) {
#pragma unroll
        for (int it = 0; it < kTile * kDepth / kThreads; ++it) {
          const int i = tid + it * kThreads;
          const int r = i / kDepth;
          const int k = i - r * kDepth;
          const int n = k0 + k;
          const int tr = t0 + r;
          const int sr = s0 + r;
          c_s[k * kStride + r] =
              (tr < Q && n < N) ? Cg[(size_t)tr * N + n] : 0.f;
          b_s[k * kStride + r] =
              (sr < Q && n < N) ? Bg[(size_t)sr * N + n] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kDepth; ++k) {
          const float4 c4 =
              *reinterpret_cast<const float4*>(c_s + k * kStride + 4 * ty);
          const float4 b4 =
              *reinterpret_cast<const float4*>(b_s + k * kStride + 4 * tx);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) cb[i][j] = fmaf(cv[i], bv[j], cb[i][j]);
        }
        __syncthreads();  // the chunk's reads are done before it is reused
      }
      // M tile, transposed, over the C/B chunks (whose last reads ended at
      // the barrier)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + 4 * tx + j;
        float m[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + 4 * ty + i;
          m[i] = 0.f;
          if (s <= t && t < Q)
            m[i] = cb[i][j] * expf(cum_s[t] - cum_s[s]) * dt_s[s];
        }
        *reinterpret_cast<float4*>(m_s + (4 * tx + j) * kStride + 4 * ty) =
            make_float4(m[0], m[1], m[2], m[3]);
      }
      __syncthreads();
      const int c_end = min(kTile, Q - s0);
      for (int c = 0; c < c_end; ++c) {
        const float4 m4 =
            *reinterpret_cast<const float4*>(m_s + c * kStride + 4 * ty);
        const float4 x4 =
            *reinterpret_cast<const float4*>(x_s + c * kTile + 4 * tx);
        const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(mv[i], xv[j], acc[i][j]);
      }
      __syncthreads();  // M and x reads are done before the next tile
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + 4 * ty + i;
      if (t >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + 4 * tx + j;
        if (p < P) y[(bh * Q + t) * P + p] = acc[i][j];
      }
    }
  } else {
    // ---- S rows [n0, n0 + 64), columns [p0, p0 + 64) -------------------
    const int st = blockIdx.x - n_y_tiles;
    const int n0 = (st / n_p_tiles) * kTile;
    const int p0 = (st % n_p_tiles) * kTile;
    float* w_s = region;                   // [position][row n]
    float* xs_s = region + kDepth * kTile; // [position][column p]
    const float cum_end = cum_s[Q - 1];
    for (int s0 = 0; s0 < Q; s0 += kDepth) {
#pragma unroll
      for (int it = 0; it < kDepth * kTile / kThreads; ++it) {
        const int i = tid + it * kThreads;
        const int r = i / kTile;
        const int cc = i - r * kTile;
        const int s = s0 + r;
        float w = 0.f, xv = 0.f;
        if (s < Q) {
          const int n = n0 + cc;
          const int p = p0 + cc;
          if (n < N)
            w = Bg[(size_t)s * N + n] * (dt_s[s] * expf(cum_end - cum_s[s]));
          if (p < P) xv = xg[(size_t)s * P + p];
        }
        w_s[i] = w;
        xs_s[i] = xv;
      }
      __syncthreads();
      const int r_end = min(kDepth, Q - s0);
      for (int r = 0; r < r_end; ++r) {
        const float4 w4 =
            *reinterpret_cast<const float4*>(w_s + r * kTile + 4 * ty);
        const float4 x4 =
            *reinterpret_cast<const float4*>(xs_s + r * kTile + 4 * tx);
        const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + 4 * ty + i;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + 4 * tx + j;
        if (p < P) S[(bh * N + n) * P + p] = acc[i][j];
      }
    }
  }
}

}  // namespace

extern "C" {

// All pointers are fp32 device arrays in the layouts above.  Returns the
// cudaError_t of the launch (0 on success).
int ssd_intra_chunk_launch(const void* x, const void* dt, const void* a,
                           const void* Bm, const void* Cm, void* y, void* S,
                           int BC, int H, int Q, int P, int N, void* stream) {
  if (BC <= 0 || H <= 0 || Q <= 0 || P <= 0 || N <= 0 || BC > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_p_tiles = (P + kTile - 1) / kTile;
  const int n_y_tiles = (Q + kTile - 1) / kTile * n_p_tiles;
  const int n_s_tiles = (N + kTile - 1) / kTile * n_p_tiles;
  const size_t smem = smem_floats(Q) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ssd_intra_chunk_kernel<<<dim3(n_y_tiles + n_s_tiles, H, BC), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(S), H, Q, P, N, n_y_tiles);
  return (int)cudaGetLastError();
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
