// Flash-attention backward kernels for Hopper (sm_90a), with a plain C
// interface.
//
// No Pallas kernel is replaced: the reference (src/repro/kernels/
// flash_attention) has no backward kernel and trains through XLA's autodiff
// of its plain paths.  These kernels compute that same gradient of the
// forward in flash_attention.cu from its output O and its fp32 per-row
// log-sum-exp LSE:
//
//   P = exp(q·kᵀ·scale − LSE) under the forward's masks (0 elsewhere),
//   Dᵢ = rowsum(dO ∘ O),  dV = Pᵀ·dO,  dS = P ∘ (dO·Vᵀ − Dᵢ),
//   dQ = dS·K·scale,  dK = dSᵀ·Q·scale,
//
// with query head h reading KV head h / G (GQA), so dK and dV sum over the
// G query heads of each group.  Inputs are read through their strides in
// the model layout (last dimension contiguous); outputs are in the inputs'
// dtypes.  Ragged S and T, the causal edge and the window are masked here.
// A row with no visible key (S > T under a window) has LSE = NEG_INF and
// every pair masked, so its P is 0 by selection, never by exp of an
// overflowed difference, and its dq is 0.
//
// Bound on this card: at the training shape (B 2, S 4096, H 12, KV 2,
// D 128, causal, bf16) the five products take 10·D operations per visible
// (query, key) pair per (b, h), 257.8 GFLOP, 0.261 ms at 989 TFLOP/s,
// against about 100 MB of inputs and outputs (0.03 ms at 3.35 TB/s): the
// tensor cores bound it.
//
// Design (the FA2 scheme, deterministic: no atomics, so two calls give the
// same bits).  Three launches from one C call, on the caller's stream:
//
// 1. `flash_bwd_dot`: Dᵢ (B, H, S) fp32, one warp a row.
// 2. `flash_bwd_dkdv_*`: a block owns (b, kv head, 64 keys) and walks the G
//    query heads of its group and only the query tiles that can see its
//    keys (under causal from its first key on, under a window up to its
//    last key + window − 1), recomputing S from q·kᵀ and LSE.  dK and dV
//    stay in fp32 registers for the whole walk, so GQA's sum needs no
//    atomics.  Blocks start from the first key tile, the one with the most
//    query tiles under a causal mask.
// 3. `flash_bwd_dq_*`: a block owns (b, h, 64 query rows) and walks the kv
//    tiles its rows see, as the forward does, recomputing S and dP; dQ
//    stays in registers and is written once (no fp32 dQ buffer).
//
// bf16 runs on the tensor cores: `mma.sync` m16n8k16, bf16 in, fp32
// accumulate.  Operand fragments come from shared memory by `ldmatrix`, the
// Kᵀ, dOᵀ and Qᵀ operands (the B side of dQ = dS·K, dV = Pᵀ·dO and dK =
// dSᵀ·Q) by `ldmatrix.trans`; rows are padded by 8 elements, which puts the
// eight rows of every 8x8 matrix on distinct banks.  Q/dO tiles (dK/dV
// pass) and K/V tiles (dQ pass) are staged by 16-byte `cp.async` with the
// zero-fill form past S, T and D into a two-stage ring, so the next tile's
// copies overlap this tile's products (a third stage would save a barrier
// a tile but halve the dQ pass's blocks a multiprocessor).  The dQ pass
// keeps its rows' q and dO fragments in registers for its whole walk.  The
// dK/dV pass runs 8 warps: warps w and w + 4 own the same 16 keys and
// split each 64-query tile in halves
// (16 fp32 scores a thread instead of 32, so the 128 accumulator registers
// of dK and dV fit without spills), and meet in shared memory at the end.
// P and dS are rounded to bf16 only as operands of a product.  D is padded
// to 32, 64 or 128 (zeros); every D that is a multiple of 8 up to 128 works.
//
// fp32 runs plain FMA, not TF32, as the forward's fp32 kernel, so that it
// holds to the plain version at 1e-4: the same two passes with 32-row
// tiles, four threads a row, each taking 8 keys (or queries) of a tile and
// a quarter of the output columns.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // (B, H, S)
  float* di;          // (B, H, S), written by the first pass
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_st, dk_sh, dv_sb, dv_st, dv_sh;
  int B, S, T, H, KV, G, D;
  int causal, window;
  float scale;        // 1 / sqrt(D)
  float scale_log2;   // log2(e) / sqrt(D)
};

__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  return col < p.T && (!p.causal || col <= row) &&
         (p.window <= 0 || row - col < p.window);
}

// some (query, key) pair of query rows [q0, q0 + rows) and keys
// [k0, k0 + bn) may be masked
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int q0,
                                                int rows, int k0, int bn) {
  return k0 + bn > p.T || (p.causal && k0 + bn - 1 > q0) ||
         (p.window > 0 && q0 + rows - 1 - k0 >= p.window);
}

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

// the query tiles [first, last) that can hold a row that sees one of keys
// [k0, k0 + bn)
__device__ __forceinline__ void q_tile_range(const Params& p, int k0, int bn,
                                             int bq, int* first, int* last) {
  const int lo = p.causal ? k0 : 0;
  int hi = p.S;
  if (p.window > 0) hi = min(hi, k0 + bn - 1 + p.window);
  *first = lo / bq;
  *last = hi > lo ? (hi + bq - 1) / bq : *first;
}

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// pass 1: Dᵢ = rowsum(dO ∘ O), one warp a (b, s, h) row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_dot(const Params p) {
  const long long r = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= static_cast<long long>(p.B) * p.S * p.H) return;
  const int h = static_cast<int>(r % p.H);
  const int s = static_cast<int>((r / p.H) % p.S);
  const int b = static_cast<int>(r / (static_cast<long long>(p.H) * p.S));
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + s * p.o_ss +
               h * p.o_sh;
  const T* d = static_cast<const T*>(p.dout) + b * p.do_sb + s * p.do_ss +
               h * p.do_sh;
  float acc = 0.f;
  for (int c = lane; c < p.D; c += 32) acc += to_f(o[c]) * to_f(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.di[(static_cast<long long>(b) * p.H + h) * p.S + s] = acc;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, ldmatrix, cp.async
// ---------------------------------------------------------------------------

constexpr int kTile = 64;   // keys a dK/dV block, rows a dQ block, tiles

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from global to shared memory, zeros when !valid (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, zeros when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a·b for one 16x8x16 tile: a row-major 16x16 bf16, b column-major
// 16x8 bf16, c/d 16x8 fp32 (PTX ISA fragment layouts)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A fragment of a 16x16 product from two adjacent 16x8 accumulators
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// lane addresses of the ldmatrix.x4 forms, for a 16 x 16 block at (r0, c0)
// of a row-major shared array: the A fragment, the B fragments of two
// 8-column n tiles from [n][k] storage, and from [k][n] storage (.trans)
template <int LD>
__device__ __forceinline__ const uint16_t* a_addr(const uint16_t (*m)[LD],
                                                  int r0, int c0, int lane) {
  return &m[r0 + (lane & 15)][c0 + (lane >> 4) * 8];
}
template <int LD>
__device__ __forceinline__ const uint16_t* bt_addr(const uint16_t (*m)[LD],
                                                   int n0, int k0, int lane) {
  return &m[n0 + (lane >> 4) * 8 + (lane & 7)][k0 + ((lane >> 3) & 1) * 8];
}
template <int LD>
__device__ __forceinline__ const uint16_t* bk_addr(const uint16_t (*m)[LD],
                                                   int k0, int n0, int lane) {
  return &m[k0 + ((lane >> 3) & 1) * 8 + (lane & 7)][n0 + (lane >> 4) * 8];
}

// rows [r0, r0 + 64) of a (rows, D) slice into shared memory by cp.async,
// zeros past `limit` rows and past D
template <int DP>
__device__ __forceinline__ void load_rows(uint16_t (*dst)[DP + 8],
                                          const uint16_t* base,
                                          long long stride, int r0, int limit,
                                          int D, int nthreads) {
  constexpr int kVecs = DP / 8;
  for (int idx = threadIdx.x; idx < kTile * kVecs; idx += nthreads) {
    const int r = idx / kVecs;
    const int c = (idx % kVecs) * 8;
    const bool ok = r0 + r < limit && c < D;
    cp_async16(&dst[r][c],
               ok ? base + static_cast<long long>(r0 + r) * stride + c : base,
               ok);
  }
}

template <int DP>
struct DkdvSmem {
  static constexpr int kLD = DP + 8;
  static constexpr int kTileBytes = kTile * kLD * 2;
  // K, V, then two stages of (Q, dO), then two stages of (lse, Dᵢ)
  static constexpr int kBytes = 6 * kTileBytes + 2 * 2 * kTile * 4;
};

template <int DP>
__global__ void __launch_bounds__(256)
    flash_bwd_dkdv_bf16(const Params p) {
  constexpr int kLD = DP + 8;
  constexpr int kN = DP / 8;   // 8-column output tiles
  constexpr int kThr = 256;
  constexpr int kQW = kTile / 2;   // queries of a tile a warp takes
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t(*Ks)[kLD] = reinterpret_cast<uint16_t(*)[kLD]>(smem);
  uint16_t(*Vs)[kLD] = Ks + kTile;
  uint16_t(*ring)[kLD] = Vs + kTile;   // stage st: Q at 2st, dO at 2st + 1
  float* stats = reinterpret_cast<float*>(ring + 4 * kTile);  // [st][2][64]

  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int kw = warp & 3;    // the warp's 16 keys
  const int qh = warp >> 2;   // its half of each 64-query tile
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  load_rows<DP>(Ks, static_cast<const uint16_t*>(p.k) + b * p.k_sb +
                        kvh * p.k_sh, p.k_st, k0, p.T, p.D, kThr);
  load_rows<DP>(Vs, static_cast<const uint16_t*>(p.v) + b * p.v_sb +
                        kvh * p.v_sh, p.v_st, k0, p.T, p.D, kThr);
  cp_async_commit();

  int first, last;
  q_tile_range(p, k0, kTile, kTile, &first, &last);
  const int nq = last - first;
  const int total = p.G * nq;

  auto issue = [&](int it) {
    const int h = kvh * p.G + it / nq;
    const int qs = (first + it % nq) * kTile;
    const int st = it & 1;
    load_rows<DP>(ring + (2 * st) * kTile,
                  static_cast<const uint16_t*>(p.q) + b * p.q_sb + h * p.q_sh,
                  p.q_ss, qs, p.S, p.D, kThr);
    load_rows<DP>(ring + (2 * st + 1) * kTile,
                  static_cast<const uint16_t*>(p.dout) + b * p.do_sb +
                      h * p.do_sh,
                  p.do_ss, qs, p.S, p.D, kThr);
    if (threadIdx.x < 2 * kTile) {
      const int r = threadIdx.x % kTile;
      const float* src = threadIdx.x < kTile ? p.lse : p.di;
      const long long at = (static_cast<long long>(b) * p.H + h) * p.S + qs + r;
      const bool ok = qs + r < p.S;
      cp_async4(&stats[(2 * st + threadIdx.x / kTile) * kTile + r],
                ok ? src + at : src, ok);
    }
  };
  if (total > 0) issue(0);
  cp_async_commit();

  float dk[kN][4], dv[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[j][i] = dv[j][i] = 0.f;

  for (int it = 0; it < total; ++it) {
    __syncthreads();   // every warp is done with the stage about to be refilled
    if (it + 1 < total) {
      issue(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = it & 1;
    const int qs = (first + it % nq) * kTile;
    const uint16_t(*Qs)[kLD] = ring + (2 * st) * kTile;
    const uint16_t(*Os)[kLD] = ring + (2 * st + 1) * kTile;
    const float* lse_s = stats + (2 * st) * kTile;
    const float* di_s = lse_s + kTile;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 16 keys x kQW queries a warp
    float s[kQW / 8][4], dp[kQW / 8][4];
#pragma unroll
    for (int j = 0; j < kQW / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, a_addr<kLD>(Ks, kw * 16, kk * 16, lane));
      ldsm_x4(va, a_addr<kLD>(Vs, kw * 16, kk * 16, lane));
#pragma unroll
      for (int jp = 0; jp < kQW / 16; ++jp) {
        uint32_t qb[4], ob[4];
        ldsm_x4(qb, bt_addr<kLD>(Qs, qh * kQW + jp * 16, kk * 16, lane));
        ldsm_x4(ob, bt_addr<kLD>(Os, qh * kQW + jp * 16, kk * 16, lane));
        mma_bf16(s[2 * jp], ka, qb[0], qb[1]);
        mma_bf16(s[2 * jp + 1], ka, qb[2], qb[3]);
        mma_bf16(dp[2 * jp], va, ob[0], ob[1]);
        mma_bf16(dp[2 * jp + 1], va, ob[2], ob[3]);
      }
    }

    // Pᵀ and dSᵀ = Pᵀ ∘ (dPᵀ − Dᵢ), in place
    const bool masked = tile_needs_mask(p, qs, kTile, k0, kTile);
#pragma unroll
    for (int j = 0; j < kQW / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + kw * 16 + g + (i >> 1) * 8;
        const int qc = qh * kQW + 8 * j + 2 * t + (i & 1);
        const bool ok = !masked || visible(p, qs + qc, key);
        const float pv =
            ok ? exp2f(s[j][i] * p.scale_log2 - lse_s[qc] * kLog2e) : 0.f;
        s[j][i] = pv;
        dp[j][i] = pv * (dp[j][i] - di_s[qc]);
      }

    // dV += Pᵀ·dO and dK += dSᵀ·Q over the warp's queries
#pragma unroll
    for (int kq = 0; kq < kQW / 16; ++kq) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * kq], s[2 * kq + 1]);
      acc_to_a(da, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int nd = 0; nd < DP / 16; ++nd) {
        uint32_t ob[4], qb[4];
        ldsm_x4_t(ob, bk_addr<kLD>(Os, qh * kQW + kq * 16, nd * 16, lane));
        ldsm_x4_t(qb, bk_addr<kLD>(Qs, qh * kQW + kq * 16, nd * 16, lane));
        mma_bf16(dv[2 * nd], pa, ob[0], ob[1]);
        mma_bf16(dv[2 * nd + 1], pa, ob[2], ob[3]);
        mma_bf16(dk[2 * nd], da, qb[0], qb[1]);
        mma_bf16(dk[2 * nd + 1], da, qb[2], qb[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // warps 4-7 hand their sums to warps 0-3 through the drained ring
  float(*red)[DP] = reinterpret_cast<float(*)[DP]>(ring);   // dK, then dV
  if (qh == 1) {
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = kw * 16 + g + (i >> 1) * 8;
        const int c = 8 * j + 2 * t + (i & 1);
        red[r][c] = dk[j][i];
        red[kTile + r][c] = dv[j][i];
      }
  }
  __syncthreads();
  if (qh == 1) return;
  __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb +
                       kvh * p.dk_sh;
  __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb +
                       kvh * p.dv_sh;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = kw * 16 + g + rr * 8;
    if (k0 + r >= p.T) continue;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int c = 8 * j + 2 * t;
      if (c >= p.D) continue;   // D is a multiple of 8: the pair is in or out
      const long long at = static_cast<long long>(k0 + r);
      *reinterpret_cast<__nv_bfloat162*>(dkb + at * p.dk_st + c) =
          __floats2bfloat162_rn(
              (dk[j][2 * rr] + red[r][c]) * p.scale,
              (dk[j][2 * rr + 1] + red[r][c + 1]) * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + at * p.dv_st + c) =
          __floats2bfloat162_rn(
              dv[j][2 * rr] + red[kTile + r][c],
              dv[j][2 * rr + 1] + red[kTile + r][c + 1]);
    }
  }
}

template <int DP>
struct DqSmem {
  static constexpr int kLD = DP + 8;
  // Q, dO, then two stages of (K, V)
  static constexpr int kBytes = 6 * kTile * kLD * 2;
};

template <int DP>
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16(const Params p) {
  constexpr int kLD = DP + 8;
  constexpr int kN = DP / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t(*Qs)[kLD] = reinterpret_cast<uint16_t(*)[kLD]>(smem);
  uint16_t(*Os)[kLD] = Qs + kTile;
  uint16_t(*ring)[kLD] = Os + kTile;   // stage st: K at 2st, V at 2st + 1

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  load_rows<DP>(Qs, static_cast<const uint16_t*>(p.q) + b * p.q_sb +
                        h * p.q_sh, p.q_ss, q0, p.S, p.D, 128);
  load_rows<DP>(Os, static_cast<const uint16_t*>(p.dout) + b * p.do_sb +
                        h * p.do_sh, p.do_ss, q0, p.S, p.D, 128);
  cp_async_commit();

  int first, last;
  kv_tile_range(p, q0, kTile, kTile, &first, &last);
  const int n = last - first;
  const uint16_t* kb = static_cast<const uint16_t*>(p.k) + b * p.k_sb +
                       kvh * p.k_sh;
  const uint16_t* vb = static_cast<const uint16_t*>(p.v) + b * p.v_sb +
                       kvh * p.v_sh;
  auto issue = [&](int it) {
    const int st = it & 1;
    load_rows<DP>(ring + (2 * st) * kTile, kb, p.k_st, (first + it) * kTile,
                  p.T, p.D, 128);
    load_rows<DP>(ring + (2 * st + 1) * kTile, vb, p.v_st,
                  (first + it) * kTile, p.T, p.D, 128);
  };
  if (n > 0) issue(0);
  cp_async_commit();
  // the warp's q and dO rows as A fragments, held for the whole walk (the
  // first commit group is Q and dO)
  uint32_t qa[DP / 16][4], oa[DP / 16][4];
  cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    ldsm_x4(qa[kk], a_addr<kLD>(Qs, warp * 16, kk * 16, lane));
    ldsm_x4(oa[kk], a_addr<kLD>(Os, warp * 16, kk * 16, lane));
  }

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse2[2], di[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long at = (static_cast<long long>(b) * p.H + h) * p.S + row[rr];
    // rows past S: P = exp2(x − inf) = 0
    lse2[rr] = row[rr] < p.S ? p.lse[at] * kLog2e : INFINITY;
    di[rr] = row[rr] < p.S ? p.di[at] : 0.f;
  }

  float dq[kN][4];
#pragma unroll
  for (int j = 0; j < kN; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int it = 0; it < n; ++it) {
    __syncthreads();
    if (it + 1 < n) {
      issue(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = it & 1;
    const int k0 = (first + it) * kTile;
    const uint16_t(*Ks)[kLD] = ring + (2 * st) * kTile;
    const uint16_t(*Vs)[kLD] = ring + (2 * st + 1) * kTile;

    // S = Q·Kᵀ and dP = dO·Vᵀ: 16 rows x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, bt_addr<kLD>(Ks, jp * 16, kk * 16, lane));
        ldsm_x4(vf, bt_addr<kLD>(Vs, jp * 16, kk * 16, lane));
        mma_bf16(s[2 * jp], qa[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], kf[2], kf[3]);
        mma_bf16(dp[2 * jp], oa[kk], vf[0], vf[1]);
        mma_bf16(dp[2 * jp + 1], oa[kk], vf[2], vf[3]);
      }
    }

    // dS = P ∘ (dP − Dᵢ), in place of s
    const bool masked = tile_needs_mask(p, q0, kTile, k0, kTile);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = i >> 1;
        const int col = k0 + 8 * j + 2 * t + (i & 1);
        const bool ok = !masked || visible(p, row[rr], col);
        const float pv = ok ? exp2f(s[j][i] * p.scale_log2 - lse2[rr]) : 0.f;
        s[j][i] = pv * (dp[j][i] - di[rr]);
      }

    // dQ += dS·K
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[4];
      acc_to_a(a, s[2 * ks], s[2 * ks + 1]);
#pragma unroll
      for (int nd = 0; nd < DP / 16; ++nd) {
        uint32_t kf[4];
        ldsm_x4_t(kf, bk_addr<kLD>(Ks, ks * 16, nd * 16, lane));
        mma_bf16(dq[2 * nd], a, kf[0], kf[1]);
        mma_bf16(dq[2 * nd + 1], a, kf[2], kf[3]);
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* qb = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb +
                      h * p.dq_sh;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (row[rr] >= p.S) continue;
    __nv_bfloat16* out = qb + static_cast<long long>(row[rr]) * p.dq_ss;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < p.D)
        *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
            dq[j][2 * rr] * p.scale, dq[j][2 * rr + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: plain FMA
// ---------------------------------------------------------------------------

constexpr int kS = 32;   // rows (keys or queries) a block and a tile

template <int DP>
constexpr int f32_smem_bytes() {
  return (4 * kS * (DP + 1) + 2 * kS * (kS + 1) + 2 * kS) * 4;
}

// rows [r0, r0 + kS) of a (rows, D) fp32 slice, zeros past limit and D
template <int DP>
__device__ __forceinline__ void load_rows_f32(float (*dst)[DP + 1],
                                              const float* base,
                                              long long stride, int r0,
                                              int limit, int D) {
  for (int idx = threadIdx.x; idx < kS * DP; idx += 128) {
    const int r = idx / DP, c = idx % DP;
    dst[r][c] = (r0 + r < limit && c < D)
                    ? base[static_cast<long long>(r0 + r) * stride + c]
                    : 0.f;
  }
}

template <int DP>
__global__ void __launch_bounds__(128) flash_bwd_dkdv_f32(const Params p) {
  extern __shared__ float smem_f[];
  float(*Ks)[DP + 1] = reinterpret_cast<float(*)[DP + 1]>(smem_f);
  float(*Vs)[DP + 1] = Ks + kS;
  float(*Qs)[DP + 1] = Ks + 2 * kS;
  float(*Os)[DP + 1] = Ks + 3 * kS;
  float(*Ps)[kS + 1] = reinterpret_cast<float(*)[kS + 1]>(Ks + 4 * kS);
  float(*Ds)[kS + 1] = Ps + kS;
  float* lse_s = reinterpret_cast<float*>(Ds + kS);
  float* di_s = lse_s + kS;

  const int k0 = blockIdx.x * kS;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int r = threadIdx.x >> 2;   // this thread's key of the block
  const int c = threadIdx.x & 3;    // its quarter of the columns
  load_rows_f32<DP>(Ks, static_cast<const float*>(p.k) + b * p.k_sb +
                            kvh * p.k_sh, p.k_st, k0, p.T, p.D);
  load_rows_f32<DP>(Vs, static_cast<const float*>(p.v) + b * p.v_sb +
                            kvh * p.v_sh, p.v_st, k0, p.T, p.D);
  float dk[DP / 4], dv[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) dk[i] = dv[i] = 0.f;

  int first, last;
  q_tile_range(p, k0, kS, kS, &first, &last);
  for (int hh = 0; hh < p.G; ++hh) {
    const int h = kvh * p.G + hh;
    for (int qt = first; qt < last; ++qt) {
      const int qs = qt * kS;
      __syncthreads();
      load_rows_f32<DP>(Qs, static_cast<const float*>(p.q) + b * p.q_sb +
                                h * p.q_sh, p.q_ss, qs, p.S, p.D);
      load_rows_f32<DP>(Os, static_cast<const float*>(p.dout) + b * p.do_sb +
                                h * p.do_sh, p.do_ss, qs, p.S, p.D);
      if (threadIdx.x < kS) {
        const long long at =
            (static_cast<long long>(b) * p.H + h) * p.S + qs + threadIdx.x;
        const bool ok = qs + threadIdx.x < p.S;
        lse_s[threadIdx.x] = ok ? p.lse[at] : 0.f;
        di_s[threadIdx.x] = ok ? p.di[at] : 0.f;
      }
      __syncthreads();
      const bool masked = tile_needs_mask(p, qs, kS, k0, kS);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int n = c * 8 + jj;   // query of the tile
        float sv = 0.f, dpv = 0.f;
#pragma unroll 8
        for (int d = 0; d < DP; ++d) {
          sv = fmaf(Ks[r][d], Qs[n][d], sv);
          dpv = fmaf(Vs[r][d], Os[n][d], dpv);
        }
        const bool ok = !masked || visible(p, qs + n, k0 + r);
        const float pv =
            ok ? exp2f(sv * p.scale_log2 - lse_s[n] * kLog2e) : 0.f;
        Ps[r][n] = pv;
        Ds[r][n] = pv * (dpv - di_s[n]);
      }
      __syncwarp();   // the key's four lanes share a warp
#pragma unroll
      for (int i = 0; i < DP / 4; ++i) {
        const int d = c + 4 * i;
        float a = dv[i], e = dk[i];
#pragma unroll 8
        for (int n = 0; n < kS; ++n) {
          a = fmaf(Ps[r][n], Os[n][d], a);
          e = fmaf(Ds[r][n], Qs[n][d], e);
        }
        dv[i] = a;
        dk[i] = e;
      }
    }
  }
  if (k0 + r >= p.T) return;
  float* dkr = static_cast<float*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh +
               static_cast<long long>(k0 + r) * p.dk_st;
  float* dvr = static_cast<float*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh +
               static_cast<long long>(k0 + r) * p.dv_st;
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) {
    const int d = c + 4 * i;
    if (d < p.D) {
      dkr[d] = dk[i] * p.scale;
      dvr[d] = dv[i];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(128) flash_bwd_dq_f32(const Params p) {
  extern __shared__ float smem_f[];
  float(*Qs)[DP + 1] = reinterpret_cast<float(*)[DP + 1]>(smem_f);
  float(*Os)[DP + 1] = Qs + kS;
  float(*Ks)[DP + 1] = Qs + 2 * kS;
  float(*Vs)[DP + 1] = Qs + 3 * kS;
  float(*Ds)[kS + 1] = reinterpret_cast<float(*)[kS + 1]>(Qs + 4 * kS);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.G;
  const int r = threadIdx.x >> 2;   // this thread's row of the block
  const int c = threadIdx.x & 3;
  const int row = q0 + r;
  load_rows_f32<DP>(Qs, static_cast<const float*>(p.q) + b * p.q_sb +
                            h * p.q_sh, p.q_ss, q0, p.S, p.D);
  load_rows_f32<DP>(Os, static_cast<const float*>(p.dout) + b * p.do_sb +
                            h * p.do_sh, p.do_ss, q0, p.S, p.D);
  const long long at = (static_cast<long long>(b) * p.H + h) * p.S + row;
  const float lse2 = row < p.S ? p.lse[at] * kLog2e : INFINITY;
  const float di = row < p.S ? p.di[at] : 0.f;
  float dq[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) dq[i] = 0.f;

  int first, last;
  kv_tile_range(p, q0, kS, kS, &first, &last);
  for (int tile = first; tile < last; ++tile) {
    const int k0 = tile * kS;
    __syncthreads();
    load_rows_f32<DP>(Ks, static_cast<const float*>(p.k) + b * p.k_sb +
                              kvh * p.k_sh, p.k_st, k0, p.T, p.D);
    load_rows_f32<DP>(Vs, static_cast<const float*>(p.v) + b * p.v_sb +
                              kvh * p.v_sh, p.v_st, k0, p.T, p.D);
    __syncthreads();
    const bool masked = tile_needs_mask(p, q0, kS, k0, kS);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int n = c * 8 + jj;   // key of the tile
      float sv = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) {
        sv = fmaf(Qs[r][d], Ks[n][d], sv);
        dpv = fmaf(Os[r][d], Vs[n][d], dpv);
      }
      const bool ok = !masked || visible(p, row, k0 + n);
      const float pv = ok ? exp2f(sv * p.scale_log2 - lse2) : 0.f;
      Ds[r][n] = pv * (dpv - di);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DP / 4; ++i) {
      const int d = c + 4 * i;
      float a = dq[i];
#pragma unroll 8
      for (int n = 0; n < kS; ++n) a = fmaf(Ds[r][n], Ks[n][d], a);
      dq[i] = a;
    }
  }
  if (row >= p.S) return;
  float* out = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh +
               static_cast<long long>(row) * p.dq_ss;
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) {
    const int d = c + 4 * i;
    if (d < p.D) out[d] = dq[i] * p.scale;
  }
}

template <typename K>
cudaError_t launch_one(K kernel, dim3 grid, int threads, int bytes,
                       const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const Params& p, int is_bf16, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.B) * p.S * p.H;
  if (is_bf16)
    flash_bwd_dot<__nv_bfloat16><<<(rows + 7) / 8, 256, 0, stream>>>(p);
  else
    flash_bwd_dot<float><<<(rows + 7) / 8, 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (is_bf16) {
    err = launch_one(flash_bwd_dkdv_bf16<DP>,
                     dim3((p.T + kTile - 1) / kTile, p.KV, p.B), 256,
                     DkdvSmem<DP>::kBytes, p, stream);
    if (err != cudaSuccess) return err;
    return launch_one(flash_bwd_dq_bf16<DP>,
                      dim3((p.S + kTile - 1) / kTile, p.H, p.B), 128,
                      DqSmem<DP>::kBytes, p, stream);
  }
  err = launch_one(flash_bwd_dkdv_f32<DP>, dim3((p.T + kS - 1) / kS, p.KV, p.B),
                   128, f32_smem_bytes<DP>(), p, stream);
  if (err != cudaSuccess) return err;
  return launch_one(flash_bwd_dq_f32<DP>, dim3((p.S + kS - 1) / kS, p.H, p.B),
                    128, f32_smem_bytes<DP>(), p, stream);
}

}  // namespace

extern "C" {

// ptrs: q, k, v, o, dout, lse, di, dq, dk, dv (device pointers; q, o, dout,
// dq (B, S, H, D), k, v, dk, dv (B, T, KV, D) of one dtype, lse and the di
// scratch (B, H, S) fp32 contiguous).  strides (elements, batch, sequence,
// head) of q, k, v, o, dout, dq, dk, dv, the last dimension contiguous; for
// bf16 every pointer is 16-byte aligned and every stride a multiple of 8.
// dims: B, S, T, H, KV, D, causal, window (0: none), is_bf16.  Launches
// the three kernels on `stream` without synchronising and returns the
// first cudaError_t (0 on success).
int flash_attention_bwd_launch(const void* const* ptrs,
                               const long long* strides, const int* dims,
                               cudaStream_t stream) {
  Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.o = ptrs[3];
  p.dout = ptrs[4];
  p.lse = static_cast<const float*>(ptrs[5]);
  p.di = static_cast<float*>(const_cast<void*>(ptrs[6]));
  p.dq = const_cast<void*>(ptrs[7]);
  p.dk = const_cast<void*>(ptrs[8]);
  p.dv = const_cast<void*>(ptrs[9]);
  long long* s[] = {&p.q_sb, &p.q_ss, &p.q_sh, &p.k_sb, &p.k_st, &p.k_sh,
                    &p.v_sb, &p.v_st, &p.v_sh, &p.o_sb, &p.o_ss, &p.o_sh,
                    &p.do_sb, &p.do_ss, &p.do_sh, &p.dq_sb, &p.dq_ss,
                    &p.dq_sh, &p.dk_sb, &p.dk_st, &p.dk_sh, &p.dv_sb,
                    &p.dv_st, &p.dv_sh};
  for (int i = 0; i < 24; ++i) *s[i] = strides[i];
  p.B = dims[0];
  p.S = dims[1];
  p.T = dims[2];
  p.H = dims[3];
  p.KV = dims[4];
  p.D = dims[5];
  p.causal = dims[6];
  p.window = dims[7];
  const int is_bf16 = dims[8];
  if (p.B < 1 || p.S < 1 || p.T < 1 || p.KV < 1 || p.H % p.KV != 0 ||
      p.D < 8 || p.D > 128 || p.D % 8 != 0 || p.B > 65535 || p.H > 65535 ||
      p.window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.G = p.H / p.KV;
  p.scale = static_cast<float>(1.0 / std::sqrt(double(p.D)));
  p.scale_log2 = static_cast<float>(1.4426950408889634 / std::sqrt(double(p.D)));
  cudaError_t err;
  if (p.D <= 32)
    err = launch<32>(p, is_bf16, stream);
  else if (p.D <= 64)
    err = launch<64>(p, is_bf16, stream);
  else
    err = launch<128>(p, is_bf16, stream);
  return static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
