// Flash-attention forward kernels for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` (body
// `_attn_kernel`) of src/repro/kernels/flash_attention/kernel.py.
//
// What it computes: softmax(q·kᵀ / sqrt(D) + mask)·v for q (B, S, H, D) and
// k, v (B, T, KV, D) in the model layout, each addressed through its own
// batch, sequence and head strides (the last dimension contiguous), so the
// (B, S, H, D) -> (B, H, S, D) transposes of the TPU wrapper are not
// needed.  Query head h reads KV head h / (H / KV) (GQA).  Query position i
// and key position j are i and j; `causal` masks j > i and `window` (0:
// none) masks i − j >= window.  The running max, denominator and
// accumulator are fp32; the output is in q's dtype; the denominator is
// clamped at 1e-37 as the TPU kernel does, and a row with no visible key
// gives a zero output.  The kernel also writes the fp32 natural-log
// log-sum-exp of every row, (B, H, S), for the backward pass (LSE = NEG_INF
// for a row with no visible key).  Ragged S and T are masked here: the TPU
// wrapper asserts S % q_block == 0.
//
// Bound on this card: at the training shape (B 2, S 4096, H 12, KV 2,
// D 128, causal, bf16) the two products take 4·B·H·D·S(S+1)/2 = 103 GFLOP,
// 0.104 ms at 989 TFLOP/s, against 58 MB of inputs and outputs (0.017 ms
// at 3.35 TB/s): the tensor cores, not memory, bound it.
//
// Design.  The TPU kernel runs the kv axis as a sequential grid dimension
// with m, l and acc in VMEM scratch carried across it.  Blocks here run in
// parallel and carry nothing, so one block owns a tile of query rows of one
// (b, h) and loops over the kv tiles itself, K and V tiles staged in shared
// memory and the online softmax in registers.  KV tiles that the causal
// mask or the window hides from every row of the block are never visited
// (the TPU kernel's `run` predicate), and the mask is evaluated only on
// tiles that straddle its edge.  Blocks start from the last query tile, the
// one with the most kv tiles under a causal mask.
//
// * bf16 (`flash_fwd_bf16`): 4 warps, 64 query rows (16 a warp), kv tiles of
//   64.  q·kᵀ and p·v run on the tensor cores with `mma.sync` m16n8k16
//   (bf16 in, fp32 accumulate).  A warp keeps its q rows as A fragments in
//   registers for the whole loop; the score accumulators of two adjacent
//   8-column tiles are, after the softmax, exactly the A fragment of the
//   p·v product, so p never leaves registers (it is rounded to bf16 for
//   the product, as every flash kernel on tensor cores does).  K and V rows
//   are padded by 8 elements in shared memory, which puts the 32 lanes'
//   fragment loads on 32 distinct banks.  The tiles are loaded with 16-byte
//   vector loads where the strides allow it.
// * fp32 (`flash_fwd_f32`): plain FMA, not TF32, so that it holds to the
//   plain fp32 version at 1e-5.  4 warps, 32 query rows, kv tiles of 32;
//   four threads share a row, each scoring 8 keys and accumulating a
//   quarter of the output columns.
//
// D is padded to 32, 64 or 128 in shared memory and registers (zeros), so
// every D that is a multiple of 8 up to 128 works (the smoke configs'
// head width 24 among them).  cp.async / TMA double buffering and `wgmma`
// are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNegInf = -2.3819763e38f;   // LSE of a row with no key
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh;
  int S, T, H, G, D;
  int causal, window;
  float scale_log2;   // log2(e) / sqrt(D)
  int vec;            // K/V rows allow 16-byte loads
};

// the kv tiles [first, last) that can hold a key visible to query rows
// [q0, q0 + rows)
__device__ __forceinline__ void kv_tile_range(const Params& p, int q0,
                                              int rows, int bn, int* first,
                                              int* last) {
  int hi = p.T;
  if (p.causal) hi = min(hi, q0 + rows);
  int lo = 0;
  if (p.window > 0) lo = max(0, q0 - p.window + 1);
  *first = lo / bn;
  *last = hi > lo ? (hi + bn - 1) / bn : *first;
}

// some (query, key) pair of the block and the tile may be masked
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int q0,
                                                int rows, int k0, int bn) {
  return k0 + bn > p.T || (p.causal && k0 + bn - 1 > q0) ||
         (p.window > 0 && q0 + rows - 1 - k0 >= p.window);
}

__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  return col < p.T && (!p.causal || col <= row) &&
         (p.window <= 0 || row - col < p.window);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kBM = 64;
constexpr int kBN = 64;

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a·b for one 16x8x16 tile: a row-major 16x16 bf16, b column-major
// 16x8 bf16, c/d 16x8 fp32 (PTX ISA fragment layouts)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [k0, k0 + kBN) of K or V into shared memory, zeros past T and D
template <int DP>
__device__ __forceinline__ void load_tile_bf16(uint16_t (*dst)[DP + 8],
                                               const uint16_t* base,
                                               long long st, int k0,
                                               const Params& p) {
  constexpr int kVecs = DP / 8;   // 16-byte vectors a row
  for (int idx = threadIdx.x; idx < kBN * kVecs; idx += kThreads) {
    const int r = idx / kVecs;
    const int c = (idx % kVecs) * 8;
    const int kr = k0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (kr < p.T && c < p.D) {
      const uint16_t* src = base + static_cast<long long>(kr) * st + c;
      if (p.vec && c + 8 <= p.D) {
        val = *reinterpret_cast<const uint4*>(src);
      } else {
        uint16_t e[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = c + i < p.D ? src[i] : 0;
        val = make_uint4(pack_raw(e[0], e[1]), pack_raw(e[2], e[3]),
                         pack_raw(e[4], e[5]), pack_raw(e[6], e[7]));
      }
    }
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const Params p) {
  constexpr int kSteps = DP / 16;   // k-steps of q·kᵀ
  constexpr int kOut = DP / 8;      // 8-column output tiles
  __shared__ __align__(16) uint16_t Ks[kBN][DP + 8];
  __shared__ __align__(16) uint16_t Vs[kBN][DP + 8];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in the group
  const uint16_t* qb = static_cast<const uint16_t*>(p.q) + b * p.q_sb +
                       h * p.q_sh;
  const uint16_t* kb = static_cast<const uint16_t*>(p.k) + b * p.k_sb +
                       (h / p.G) * p.k_sh;
  const uint16_t* vb = static_cast<const uint16_t*>(p.v) + b * p.v_sb +
                       (h / p.G) * p.v_sh;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // the warp's 16 query rows as A fragments, zeros past S and D
  uint32_t qa[kSteps][4];
  auto q_at = [&](int r, int c) -> uint16_t {
    return (r < p.S && c < p.D) ? qb[static_cast<long long>(r) * p.q_ss + c]
                                : uint16_t(0);
  };
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = pack_raw(q_at(row[0], c), q_at(row[0], c + 1));
    qa[kk][1] = pack_raw(q_at(row[1], c), q_at(row[1], c + 1));
    qa[kk][2] = pack_raw(q_at(row[0], c + 8), q_at(row[0], c + 9));
    qa[kk][3] = pack_raw(q_at(row[1], c + 8), q_at(row[1], c + 9));
  }

  float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
  float l[2] = {0.f, 0.f};               // this thread's share of the sum
  float o[kOut][4];
#pragma unroll
  for (int j = 0; j < kOut; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  int first, last;
  kv_tile_range(p, q0, kBM, kBN, &first, &last);
  for (int tile = first; tile < last; ++tile) {
    const int k0 = tile * kBN;
    __syncthreads();   // every warp is done with the previous tile
    load_tile_bf16<DP>(Ks, kb, p.k_st, k0, p);
    load_tile_bf16<DP>(Vs, vb, p.v_st, k0, p);
    __syncthreads();

    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(&Ks[8 * j + g][kk * 16 + 2 * t]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
            &Ks[8 * j + g][kk * 16 + 8 + 2 * t]);
        mma_bf16(s[j], qa[kk], b0, b1);
      }
    }
    const bool masked = tile_needs_mask(p, q0, kBM, k0, kBN);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[j][i] * p.scale_log2;
        if (masked && !visible(p, row[i >> 1], k0 + 8 * j + 2 * t + (i & 1)))
          x = -INFINITY;
        s[j][i] = x;
      }
    }

    // online softmax, rows g and g + 8 (four lanes share a row)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * rr], s[j][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[rr] - m_use);
      m[rr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        s[j][2 * rr] = exp2f(s[j][2 * rr] - m_use);
        s[j][2 * rr + 1] = exp2f(s[j][2 * rr + 1] - m_use);
        sum += s[j][2 * rr] + s[j][2 * rr + 1];
      }
      l[rr] = l[rr] * corr + sum;
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        o[j][2 * rr] *= corr;
        o[j][2 * rr + 1] *= corr;
      }
    }

    // o += p·v: two adjacent score tiles form one 16x16 A fragment
#pragma unroll
    for (int ks = 0; ks < kBN / 16; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
      const int r0 = 16 * ks + 2 * t;
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const int n = 8 * j + g;
        const uint32_t b0 = pack_raw(Vs[r0][n], Vs[r0 + 1][n]);
        const uint32_t b1 = pack_raw(Vs[r0 + 8][n], Vs[r0 + 9][n]);
        mma_bf16(o[j], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                      h * p.o_sh;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row[rr];
    if (r >= p.S) continue;
    const float inv_l = 1.f / fmaxf(l[rr], 1e-37f);
    __nv_bfloat16* orow = ob + static_cast<long long>(r) * p.o_ss;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < p.D) orow[c] = __float2bfloat16(o[j][2 * rr] * inv_l);
      if (c + 1 < p.D) orow[c + 1] = __float2bfloat16(o[j][2 * rr + 1] * inv_l);
    }
    if (t == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.S + r] =
          l[rr] > 0.f ? m[rr] * kLn2 + logf(l[rr]) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// fp32: plain FMA
// ---------------------------------------------------------------------------

constexpr int kSM = 32;   // query rows a block
constexpr int kSN = 32;   // keys a tile

template <int DP>
constexpr int f32_smem_bytes() {
  return (3 * kSM * (DP + 1) + kSM * (kSN + 1)) * 4;
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p) {
  extern __shared__ float smem[];
  float(*Qs)[DP + 1] = reinterpret_cast<float(*)[DP + 1]>(smem);
  float(*Ks)[DP + 1] = reinterpret_cast<float(*)[DP + 1]>(smem + kSM * (DP + 1));
  float(*Vs)[DP + 1] =
      reinterpret_cast<float(*)[DP + 1]>(smem + 2 * kSM * (DP + 1));
  float(*Ps)[kSN + 1] =
      reinterpret_cast<float(*)[kSN + 1]>(smem + 3 * kSM * (DP + 1));

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kSM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int r = threadIdx.x >> 2;   // this thread's row of the block
  const int c = threadIdx.x & 3;    // its quarter of the row
  const int row = q0 + r;
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb =
      static_cast<const float*>(p.k) + b * p.k_sb + (h / p.G) * p.k_sh;
  const float* vb =
      static_cast<const float*>(p.v) + b * p.v_sb + (h / p.G) * p.v_sh;

  for (int idx = threadIdx.x; idx < kSM * DP; idx += kThreads) {
    const int rr = idx / DP, d = idx % DP;
    Qs[rr][d] = (q0 + rr < p.S && d < p.D)
                    ? qb[static_cast<long long>(q0 + rr) * p.q_ss + d]
                    : 0.f;
  }

  float m = -INFINITY, l = 0.f;
  float o[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) o[i] = 0.f;

  int first, last;
  kv_tile_range(p, q0, kSM, kSN, &first, &last);
  for (int tile = first; tile < last; ++tile) {
    const int k0 = tile * kSN;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kSN * DP; idx += kThreads) {
      const int rr = idx / DP, d = idx % DP;
      const bool in = k0 + rr < p.T && d < p.D;
      Ks[rr][d] = in ? kb[static_cast<long long>(k0 + rr) * p.k_st + d] : 0.f;
      Vs[rr][d] = in ? vb[static_cast<long long>(k0 + rr) * p.v_st + d] : 0.f;
    }
    __syncthreads();

    const bool masked = tile_needs_mask(p, q0, kSM, k0, kSN);
    float s[8];
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = c * 8 + jj;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) acc = fmaf(Qs[r][d], Ks[n][d], acc);
      float x = acc * p.scale_log2;
      if (masked && !visible(p, row, k0 + n)) x = -INFINITY;
      s[jj] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float corr = exp2f(m - m_use);
    m = m_new;
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float e = exp2f(s[jj] - m_use);
      Ps[r][c * 8 + jj] = e;
      sum += e;
    }
    l = l * corr + sum;
    __syncwarp();   // the row's four lanes share a warp
#pragma unroll
    for (int i = 0; i < DP / 4; ++i) {
      const int d = c + 4 * i;
      float acc = o[i] * corr;
#pragma unroll 8
      for (int n = 0; n < kSN; ++n) acc = fmaf(Ps[r][n], Vs[n][d], acc);
      o[i] = acc;
    }
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (row >= p.S) return;
  float* orow = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh +
                static_cast<long long>(row) * p.o_ss;
  const float lc = fmaxf(l, 1e-37f);
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) {
    const int d = c + 4 * i;
    if (d < p.D) orow[d] = o[i] / lc;
  }
  if (c == 0)
    p.lse[(static_cast<long long>(b) * p.H + h) * p.S + row] =
        l > 0.f ? m * kLn2 + logf(l) : kNegInf;
}

template <int DP>
cudaError_t launch(const Params& p, int B, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    dim3 grid((p.S + kBM - 1) / kBM, p.H, B);
    flash_fwd_bf16<DP><<<grid, kThreads, 0, stream>>>(p);
  } else {
    constexpr int bytes = f32_smem_bytes<DP>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((p.S + kSM - 1) / kSM, p.H, B);
    flash_fwd_f32<DP><<<grid, kThreads, bytes, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, S, H, D); k, v: (B, T, KV, D); o: (B, S, H, D), all of one dtype
// (fp32, or bf16 when is_bf16), strides in elements, the last dimension
// contiguous; lse: (B, H, S) fp32 contiguous.  window 0 means none.
// Returns the launch's cudaError_t (0 on success) without synchronising.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, long long q_sb, long long q_ss,
                           long long q_sh, long long k_sb, long long k_st,
                           long long k_sh, long long v_sb, long long v_st,
                           long long v_sh, long long o_sb, long long o_ss,
                           long long o_sh, int B, int S, int T, int H, int KV,
                           int D, int causal, int window, int is_bf16,
                           cudaStream_t stream) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 || D < 8 || D > 128 ||
      D % 8 != 0 || B > 65535 || H > 65535 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.S = S;
  p.T = T;
  p.H = H;
  p.G = H / KV;
  p.D = D;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = static_cast<float>(1.4426950408889634 / std::sqrt(double(D)));
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  p.vec = aligned(k) && aligned(v) && k_sb % 8 == 0 && k_st % 8 == 0 &&
          k_sh % 8 == 0 && v_sb % 8 == 0 && v_st % 8 == 0 && v_sh % 8 == 0;
  cudaError_t err;
  if (D <= 32)
    err = launch<32>(p, B, is_bf16, stream);
  else if (D <= 64)
    err = launch<64>(p, B, is_bf16, stream);
  else
    err = launch<128>(p, B, is_bf16, stream);
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
