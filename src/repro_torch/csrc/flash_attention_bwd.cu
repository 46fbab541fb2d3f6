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
// tensor cores bound it.  The scheme below has no atomics, so the dQ pass
// recomputes S and dP: it issues 14·D a pair, whose floor is 0.365 ms.
// gemma3-4b's (B 2, S 4096, H 8, KV 4, D 256): 0.3475 ms causal, 0.1520
// under its window of 1,024 (0.487 and 0.213 issued).
//
// Design (deterministic: no atomics, so two calls give the same bits).
// Three launches from one C call, on the caller's stream:
//
// 1. `flash_bwd_dot`: Dᵢ (B, H, S) fp32, one warp a row.
// 2. `flash_bwd_dkdv_*`: a block owns (b, kv head, 64 keys) and walks the G
//    query heads of its group and only the query tiles that can see its
//    keys (under causal from its first key on, under a window up to its
//    last key + window − 1), recomputing S from q·kᵀ and LSE.  dK and dV
//    stay in fp32 registers for the whole walk, so GQA's sum needs no
//    atomics.
// 3. `flash_bwd_dq_*`: a block owns (b, h, 128 query rows) and walks the
//    kv tiles its rows see, as the forward does, recomputing S and dP; dQ
//    stays in registers and is written once (no fp32 dQ buffer).
//
// bf16 runs on TMA, mbarriers and `wgmma` (the forward's building blocks,
// hopper_common.cuh).  Every tile is brought by TMA in the 128-byte swizzle,
// zero-filled past S, T and D (D is padded to 64, 128 or 256), and every
// product is `wgmma.mma_async` with fp32 accumulators:
//
// * dK/dV pass (`flash_bwd_dkdv_wgmma`, 384 threads): two consumer
//   warpgroups own the same 64 keys and take alternate (head, query tile)
//   steps of the walk; a producer warp (its warpgroup hands its registers to
//   the consumers with `setmaxnreg`, 40 / 232) loads K and V once and
//   streams Q, dO (64 rows each) and the tile's LSE·log2e and Dᵢ rows into
//   a ring of four stages, two a consumer, each with a "full" and a "free"
//   mbarrier.  A consumer computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (both operands
//   in shared memory, K-major; two commit groups, so Pᵀ is computed while
//   dPᵀ runs), Pᵀ = 2^(Sᵀ·scale·log2e − LSE·log2e) selected to 0 where
//   masked, dSᵀ = Pᵀ ∘ (dPᵀ − Dᵢ) in registers, then dV += Pᵀ·dO and dK +=
//   dSᵀ·Q with Pᵀ and dSᵀ rounded to bf16 as the register A operand and
//   dO, Q read in their own (row) layout through the transpose flag (the
//   forward's p·v).  At the end the warpgroups swap halves through the
//   drained ring: one sums and writes dK, the other dV.
//   Load balance: under causal, key tile 0 sees every query tile, twice
//   the average; blocks of 64 keys (256 at the training shape, one a
//   multiprocessor: 192 accumulator registers a consumer thread) start
//   with the heaviest key tiles, so the card pairs a light block with each
//   heavy one and the longest block (6 heads x 64 query tiles) is about an
//   average multiprocessor's share (378 such steps).  Blocks of 128 keys
//   (a warpgroup each, sharing every Q, dO tile) ran no faster without a
//   mask and, under causal, as long as their heaviest block.
// * dQ pass (`flash_bwd_dq_wgmma`, the forward's 128-row shape): two
//   consumer warpgroups of 64 query rows and a producer warpgroup
//   (`setmaxnreg` 40 / 232).  Q and dO come once, K and V (64 keys a tile)
//   through two-stage rings of their own that both consumers read (V,
//   read by dP alone, frees its stage first).  S = Q·Kᵀ and dP =
//   dO·Vᵀ from shared memory (two groups again), dS = P ∘ (dP − Dᵢ) in
//   registers, dQ += dS·K with dS the register A operand and K through the
//   transpose flag.  Blocks start from the last query tile, the one with
//   the most kv tiles under causal.  Blocks of 64 rows (a producer warp,
//   two blocks a multiprocessor) spill at the 168 registers that leaves a
//   thread; 128-key tiles spill as well.
// * At D 256 (gemma3) a 64-row tile is 32 KB and a 64 x 256 fp32
//   accumulator 128 registers a thread, so both passes change shape:
//   - dK/dV (`flash_bwd_dkdv_split_wgmma`): the two consumer warpgroups
//     split the accumulators, not the walk.  Warpgroup 0 owns dV: Sᵀ =
//     K·Qᵀ, Pᵀ, then dV += Pᵀ·dO; it hands Pᵀ (bf16, 8 KB) to warpgroup 1
//     through shared memory on an mbarrier pair a stage.  Warpgroup 1 owns
//     dK: dPᵀ = V·dOᵀ, then dK += dSᵀ·Q with dSᵀ = Pᵀ ∘ (dPᵀ − Dᵢ).  Each
//     holds 128 accumulators and one score tile (176 live; the D 128
//     layout would hold dK and dV, 256, beside S and dP); both read one
//     (Q, dO) ring of two stages (K, V, the ring and two Pᵀ buffers: 210
//     KB); each writes its own output, so the swap through the ring goes.
//   - dQ: 128 rows as at D 128.  Q and dO take 128 KB, so the K ring
//     keeps two tiles and the V ring one (225 KB): the next K lands
//     during a tile, the next V during its dS and dQ products (one shared
//     (K, V) stage left every copy exposed, and the pass took 1.42x as
//     long at gemma3's training shape on an H100).  dP is issued after P
//     is rounded to bf16 (176 live accumulators, not 192), so its product
//     does not overlap the exponentials.
//   dSᵀ and dS are formed from the bf16 P here, which the products read
//   anyway.
// * Between the products, a tile's elementwise step is what bounds it: the
//   exponential is `ex2.approx.ftz` computed for every element and then
//   selected (a conditional `exp2f` compiled to a branch, a load and an
//   exponential one element after another), the LSE·log2e and Dᵢ pairs are
//   read from shared memory, and the mask test is taken once a tile.
//
// Against this source's earlier `mma.sync` design (2.80 ms at the training
// shape): no `ldmatrix` (wgmma reads shared memory itself), no `cp.async`
// from every thread (one TMA issue a tile, overlapped by the ring), no
// 8-warp block at 238 registers, and the causal load balance above.
//
// fp32 runs plain FMA, not TF32, as the forward's fp32 kernel, so that it
// holds to the plain version at 1e-4: the same two passes with 32-row
// tiles, four threads a row, each taking 8 keys (or queries) of a tile and
// a quarter of the output columns.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu

#include <climits>
#include <cmath>

#include "hopper_common.cuh"

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
// bf16: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

constexpr int kRing = 4;     // (Q, dO) stages of the dK/dV pass: two a consumer

struct Maps {
  CUtensorMap q, k, v, dout;
};

// named barrier `id` over the `count` threads that reach it
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// rows row0 and row0 + 8 of a warpgroup's 64 x DP accumulator (one
// 64-column chunk a slice), times `scale`, as bf16 pairs; rows from
// `limit` on and columns from D on are not written
template <int kChunks>
__device__ __forceinline__ void store_rows(const float (&acc)[kChunks][32],
                                           __nv_bfloat16* base,
                                           long long stride, int row0,
                                           int limit, int D, float scale) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + 8 * rr;
    if (r >= limit) continue;
    __nv_bfloat16* out = base + static_cast<long long>(r) * stride;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * 64 + 8 * j + 2 * t;
        if (col < D)   // D is a multiple of 8: the pair is in or out
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(acc[c][4 * j + 2 * rr] * scale,
                                    acc[c][4 * j + 2 * rr + 1] * scale);
      }
  }
}

template <int DP>
struct DkdvShape {
  static constexpr int kChunks = DP / 64;             // 64-column slices of D
  static constexpr int kTileBytes = kChunks * kBox;   // 64 rows of K, V, Q, dO
  static constexpr int kThreadsAll = 3 * 128;         // 2 consumers, producer
  // K, V, the ring of (Q, dO), a stage's LSE·log2e and Dᵢ rows, barriers
  static constexpr int kSmem = 1024 + (2 + 2 * kRing) * kTileBytes +
                               kRing * 2 * 64 * 4 + (1 + 2 * kRing) * 8;
  // the consumers swap a dK and a dV partial through the drained ring
  static_assert(2 * kChunks * 32 * 128 * 4 <= 2 * kRing * kTileBytes, "");
};

// the producer warp of a dK/dV block: K and V once, then the walk's (Q, dO)
// tiles and their LSE·log2e and Dᵢ rows into a ring of `Ring` stages
template <int DP, int Ring>
__device__ __forceinline__ void dkdv_produce(
    const Maps& maps, const Params& p, uint8_t* ks, uint8_t* vs,
    uint8_t* ring, float* stats, uint64_t* kv_full, uint64_t* full,
    uint64_t* empty, int k0, int kvh, int b, int first, int nq, int total) {
  constexpr int kChunks = DP / 64;
  constexpr int kTileBytes = kChunks * kBox;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    mbar_expect_tx(kv_full, 2 * kTileBytes);
    for (int c = 0; c < kChunks; ++c) {
      tma_load(ks + c * kBox, &maps.k, kv_full, c * 64, kvh, k0, b);
      tma_load(vs + c * kBox, &maps.v, kv_full, c * 64, kvh, k0, b);
    }
  }
  for (int it = 0; it < total; ++it) {
    const int st = it % Ring;
    const int h = kvh * p.G + it / nq;
    const int qs = (first + it % nq) * 64;
    const long long at = (static_cast<long long>(b) * p.H + h) * p.S + qs;
    // the tile's LSE (log2 units) and Dᵢ rows, read before the wait; rows
    // past S get LSE +inf, so P = 0 there
    float l2[2], di[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = lane + 32 * r;
      const bool ok = qs + row < p.S;
      l2[r] = ok ? p.lse[at + row] * kLog2e : INFINITY;
      di[r] = ok ? p.di[at + row] : 0.f;
    }
    if (it >= Ring) mbar_wait(&empty[st], ((it / Ring) & 1) ^ 1);
    float* sl = stats + st * 128;
    sl[lane] = l2[0];
    sl[lane + 32] = l2[1];
    sl[64 + lane] = di[0];
    sl[96 + lane] = di[1];
    if (lane == 0) {
      uint8_t* qt = ring + 2 * st * kTileBytes;
      uint8_t* ot = qt + kTileBytes;
      mbar_expect_tx(&full[st], 2 * kTileBytes);
      for (int c = 0; c < kChunks; ++c) {
        tma_load(qt + c * kBox, &maps.q, &full[st], c * 64, h, qs, b);
        tma_load(ot + c * kBox, &maps.dout, &full[st], c * 64, h, qs, b);
      }
    }
    __syncwarp();
    mbar_arrive(&full[st]);   // the lane's stats stores, released
  }
}

// consumer warpgroup wg (0 or 1): steps wg, wg + 2, ... of the walk
template <int DP>
__device__ __forceinline__ void dkdv_consume(
    const Params& p, uint8_t* ks, uint8_t* vs, uint8_t* ring,
    const float* stats, uint64_t* kv_full, uint64_t* full, uint64_t* empty,
    int k0, int kvh, int b, int first, int nq, int total, int wg) {
  using Sh = DkdvShape<DP>;
  constexpr int kChunks = Sh::kChunks;
  const int tid = threadIdx.x % 128;
  const int t = tid % 4;
  const int key0 = k0 + (tid / 32) * 16 + (tid % 32) / 4;   // and key0 + 8
  const uint32_t k_addr = smem_u32(ks);
  const uint32_t v_addr = smem_u32(vs);

  float dk[kChunks][32], dv[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;

  mbar_wait(kv_full, 0);   // also when the walk is empty: no copy outlives us
  for (int it = wg; it < total; it += 2) {
    const int st = it % kRing;
    const int qs = (first + it % nq) * 64;
    const uint32_t q_addr = smem_u32(ring + 2 * st * Sh::kTileBytes);
    const uint32_t o_addr = q_addr + Sh::kTileBytes;
    mbar_wait(&full[st], (it / kRing) & 1);

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (64 keys x 64 queries), two groups, so
    // that Pᵀ is computed while dPᵀ runs
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(s, sw128_desc(k_addr + (kk / 4) * kBox + (kk % 4) * 32),
               sw128_desc(q_addr + (kk / 4) * kBox + (kk % 4) * 32), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(dp, sw128_desc(v_addr + (kk / 4) * kBox + (kk % 4) * 32),
               sw128_desc(o_addr + (kk / 4) * kBox + (kk % 4) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();

    // Pᵀ in place.  Element i is key key0 + 8 ((i >> 1) & 1) and query
    // qs + 8 (i / 4) + 2t + (i & 1), whose LSE·log2e and Dᵢ are a pair
    // of the stage's rows; every exponential is computed, then selected,
    // so the loop has no branch
    const float2* lse2 = reinterpret_cast<const float2*>(stats + st * 128);
    const float2* di = lse2 + 32;
    if (tile_needs_mask(p, qs, 64, k0, 64)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float2 l = lse2[4 * (i / 4) + t];
        const int qc = 8 * (i / 4) + 2 * t + (i & 1);
        const float e = fast_exp2(s[i] * p.scale_log2 - (i & 1 ? l.y : l.x));
        s[i] = visible(p, qs + qc, key0 + 8 * ((i >> 1) & 1)) ? e : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float2 l = lse2[4 * (i / 4) + t];
        s[i] = fast_exp2(s[i] * p.scale_log2 - (i & 1 ? l.y : l.x));
      }
    }

    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float2 d = di[4 * (i / 4) + t];
      dp[i] = s[i] * (dp[i] - (i & 1 ? d.y : d.x));
    }
    // dV += Pᵀ·dO and dK += dSᵀ·Q, 16 queries a step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[8 * kk], s[8 * kk + 1]),
                              pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                              pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                              pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
      const uint32_t da[4] = {pack_bf16(dp[8 * kk], dp[8 * kk + 1]),
                              pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]),
                              pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]),
                              pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7])};
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        wgmma_rs_tb(dv[c], pa, sw128_desc(o_addr + c * kBox + kk * 2048));
        wgmma_rs_tb(dk[c], da, sw128_desc(q_addr + c * kBox + kk * 2048));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(&empty[st]);
  }

  __nv_bfloat16* dkb =
      static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  __nv_bfloat16* dvb =
      static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
  // every copy into the ring has been waited for and every product read:
  // warpgroup 1 hands its dK to warpgroup 0, which hands its dV back, in
  // the accumulators' own order (conflict-free)
  bar_sync(1, 256);
  float* red_k = reinterpret_cast<float*>(ring);
  float* red_v = red_k + kChunks * 32 * 128;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (wg == 0)
        red_v[(c * 32 + i) * 128 + tid] = dv[c][i];
      else
        red_k[(c * 32 + i) * 128 + tid] = dk[c][i];
    }
  bar_sync(1, 256);
  if (wg == 0) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[c][i] += red_k[(c * 32 + i) * 128 + tid];
    store_rows<kChunks>(dk, dkb, p.dk_st, key0, p.T, p.D, p.scale);
  } else {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dv[c][i] += red_v[(c * 32 + i) * 128 + tid];
    store_rows<kChunks>(dv, dvb, p.dv_st, key0, p.T, p.D, 1.f);
  }
}

template <int DP>
__global__ void __launch_bounds__(DkdvShape<DP>::kThreadsAll, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ Maps maps, const Params p) {
  using Sh = DkdvShape<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);   // swizzled tiles: 1024-byte aligned
  uint8_t* vs = ks + Sh::kTileBytes;
  uint8_t* ring = vs + Sh::kTileBytes;   // stage st: Q at 2st, dO at 2st + 1
  float* stats = reinterpret_cast<float*>(ring + 2 * kRing * Sh::kTileBytes);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + kRing * 128);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kRing;

  // key tiles vary slowest, so the heaviest under causal (tile 0) go first
  const int nb = p.KV * p.B;
  const int k0 = (blockIdx.x / nb) * 64;
  const int kvh = (blockIdx.x % nb) % p.KV;
  const int b = (blockIdx.x % nb) / p.KV;
  int first, last;
  q_tile_range(p, k0, 64, 64, &first, &last);
  const int nq = last - first;
  const int total = p.G * nq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 33);   // the copies' expect_tx, 32 lanes' stats
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform for the compiler (a shuffle result), so the wgmma below
  // are not taken to sit on a divergent path
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // 40 + 2 x 232 registers a thread fit the register file
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x / 32 == 8)
      dkdv_produce<DP, kRing>(maps, p, ks, vs, ring, stats, kv_full, full,
                              empty, k0, kvh, b, first, nq, total);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    dkdv_consume<DP>(p, ks, vs, ring, stats, kv_full, full, empty, k0, kvh,
                     b, first, nq, total, wg);
  }
}

// dK/dV at head dim 256 (see the design note above): warpgroup 0 owns dV,
// warpgroup 1 dK, both take every step of the walk.  Pᵀ has a buffer a
// ring stage, with a "full" and a "free" mbarrier, so warpgroup 0 runs up
// to two steps ahead.
constexpr int kSplitRing = 2;   // (Q, dO) stages: 64 KB each

template <int DP>
struct DkdvSplitShape {
  static constexpr int kChunks = DP / 64;
  static constexpr int kTileBytes = kChunks * kBox;   // 64 rows of K, V, Q, dO
  static constexpr int kPWords = 16 * 128;            // a Pᵀ tile, bf16 pairs
  static constexpr int kThreadsAll = 3 * 128;
  // K, V, the ring of (Q, dO), the Pᵀ buffers, a stage's LSE·log2e and Dᵢ
  // rows, barriers
  static constexpr int kSmem = 1024 + (2 + 2 * kSplitRing) * kTileBytes +
                               kSplitRing * kPWords * 4 +
                               kSplitRing * 2 * 64 * 4 +
                               (1 + 4 * kSplitRing) * 8;
  static_assert(kSmem <= 232448, "tiles exceed the shared memory of a block");
};

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// consumer warpgroup wg: 0 owns dV, 1 owns dK
template <int DP>
__device__ __forceinline__ void dkdv_split_consume(
    const Params& p, uint8_t* ks, uint8_t* vs, uint8_t* ring,
    const float* stats, uint32_t* pt, uint64_t* kv_full, uint64_t* full,
    uint64_t* empty, uint64_t* p_full, uint64_t* p_free, int k0, int kvh,
    int b, int first, int nq, int total, int wg) {
  using Sh = DkdvSplitShape<DP>;
  constexpr int kChunks = Sh::kChunks;
  const int tid = threadIdx.x % 128;
  const int t = tid % 4;
  const int key0 = k0 + (tid / 32) * 16 + (tid % 32) / 4;   // and key0 + 8
  // Sᵀ = K·Qᵀ (warpgroup 0) or dPᵀ = V·dOᵀ (warpgroup 1)
  const uint32_t a_addr = smem_u32(wg == 0 ? ks : vs);

  float acc[kChunks][32];   // dV or dK
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  mbar_wait(kv_full, 0);   // also when the walk is empty: no copy outlives us
  for (int it = 0; it < total; ++it) {
    const int st = it % kSplitRing;
    const int ph = (it / kSplitRing) & 1;
    const int qs = (first + it % nq) * 64;
    const uint32_t q_addr = smem_u32(ring + 2 * st * Sh::kTileBytes);
    const uint32_t o_addr = q_addr + Sh::kTileBytes;
    mbar_wait(&full[st], ph);

    float s[32];
    const uint32_t b_addr = wg == 0 ? q_addr : o_addr;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(s, sw128_desc(a_addr + (kk / 4) * kBox + (kk % 4) * 32),
               sw128_desc(b_addr + (kk / 4) * kBox + (kk % 4) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();

    // element i is key key0 + 8 ((i >> 1) & 1) and query qs + 8 (i / 4) +
    // 2t + (i & 1); word j of a thread's Pᵀ or dSᵀ packs elements 2j, 2j + 1
    const float2* lse2 = reinterpret_cast<const float2*>(stats + st * 128);
    const float2* di = lse2 + 32;
    uint32_t* pbuf = pt + st * Sh::kPWords;
    uint32_t w[16];
    if (wg == 0) {
      // Pᵀ: every exponential computed, then selected (no branch)
      if (tile_needs_mask(p, qs, 64, k0, 64)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float2 l = lse2[4 * (i / 4) + t];
          const int qc = 8 * (i / 4) + 2 * t + (i & 1);
          const float e = fast_exp2(s[i] * p.scale_log2 - (i & 1 ? l.y : l.x));
          s[i] = visible(p, qs + qc, key0 + 8 * ((i >> 1) & 1)) ? e : 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float2 l = lse2[4 * (i / 4) + t];
          s[i] = fast_exp2(s[i] * p.scale_log2 - (i & 1 ? l.y : l.x));
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
      if (it >= kSplitRing) mbar_wait(&p_free[st], ph ^ 1);
#pragma unroll
      for (int j = 0; j < 16; ++j) pbuf[j * 128 + tid] = w[j];
      mbar_arrive(&p_full[st]);
    } else {
      mbar_wait(&p_full[st], ph);
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = pbuf[j * 128 + tid];
      mbar_arrive(&p_free[st]);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 d = di[4 * (j / 2) + t];
        w[j] = pack_bf16(bf16_lo(w[j]) * (s[2 * j] - d.x),
                         bf16_hi(w[j]) * (s[2 * j + 1] - d.y));
      }
    }

    // dV += Pᵀ·dO (warpgroup 0) or dK += dSᵀ·Q (warpgroup 1), 16 queries
    // a step, the packed tile as the register A operand
    const uint32_t c_addr = wg == 0 ? o_addr : q_addr;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {w[4 * kk], w[4 * kk + 1], w[4 * kk + 2],
                             w[4 * kk + 3]};
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        wgmma_rs_tb(acc[c], a, sw128_desc(c_addr + c * kBox + kk * 2048));
    }
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(&empty[st]);
  }

  if (wg == 0)
    store_rows<kChunks>(acc,
                        static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb +
                            kvh * p.dv_sh,
                        p.dv_st, key0, p.T, p.D, 1.f);
  else
    store_rows<kChunks>(acc,
                        static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb +
                            kvh * p.dk_sh,
                        p.dk_st, key0, p.T, p.D, p.scale);
}

template <int DP>
__global__ void __launch_bounds__(DkdvSplitShape<DP>::kThreadsAll, 1)
    flash_bwd_dkdv_split_wgmma(const __grid_constant__ Maps maps,
                               const Params p) {
  using Sh = DkdvSplitShape<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);   // swizzled tiles: 1024-byte aligned
  uint8_t* vs = ks + Sh::kTileBytes;
  uint8_t* ring = vs + Sh::kTileBytes;   // stage st: Q at 2st, dO at 2st + 1
  uint32_t* pt =
      reinterpret_cast<uint32_t*>(ring + 2 * kSplitRing * Sh::kTileBytes);
  float* stats = reinterpret_cast<float*>(pt + kSplitRing * Sh::kPWords);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + kSplitRing * 128);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kSplitRing;
  uint64_t* p_full = empty + kSplitRing;
  uint64_t* p_free = p_full + kSplitRing;

  // key tiles vary slowest, so the heaviest under causal (tile 0) go first
  const int nb = p.KV * p.B;
  const int k0 = (blockIdx.x / nb) * 64;
  const int kvh = (blockIdx.x % nb) % p.KV;
  const int b = (blockIdx.x % nb) / p.KV;
  int first, last;
  q_tile_range(p, k0, 64, 64, &first, &last);
  const int nq = last - first;
  const int total = p.G * nq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kSplitRing; ++s) {
      mbar_init(&full[s], 33);    // the copies' expect_tx, 32 lanes' stats
      mbar_init(&empty[s], 256);  // both consumer warpgroups
      mbar_init(&p_full[s], 128);
      mbar_init(&p_free[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x / 32 == 8)
      dkdv_produce<DP, kSplitRing>(maps, p, ks, vs, ring, stats, kv_full,
                                   full, empty, k0, kvh, b, first, nq, total);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    dkdv_split_consume<DP>(p, ks, vs, ring, stats, pt, kv_full, full, empty,
                           p_full, p_free, k0, kvh, b, first, nq, total, wg);
  }
}

constexpr int kDqRows = 128;   // query rows a dQ block: two warpgroups

template <int DP>
struct DqShape {
  static constexpr int kChunks = DP / 64;
  // two consumer warpgroups and a producer warpgroup that hands its
  // registers to them
  static constexpr int kThreadsAll = 3 * 128;
  static constexpr int kQBytes = kChunks * kDqRows * 128;   // Q, and dO
  static constexpr int kTileBytes = kChunks * kBox;   // 64 keys of K or V
  // K and V come through rings of their own: V is read by dP alone and
  // frees its stage before K, which dQ's product reads too.  At D 256 Q
  // and dO take 128 KB, so two K tiles and one V tile (96 KB) fit: the
  // next K lands during a tile, the next V during its dS and dQ
  static constexpr int kKStages = 2;
  static constexpr int kVStages = DP > 128 ? 1 : 2;
  // dP issued beside the exponentials of P: S, dP and dQ live at once
  // (192 accumulators at D 256, past the 232 registers with addressing),
  // so at D 256 dP is issued after P is packed to bf16
  static constexpr bool kOverlap = DP <= 128;
  static constexpr int kSmem = 1024 + 2 * kQBytes +
                               (kKStages + kVStages) * kTileBytes +
                               (1 + 2 * kKStages + 2 * kVStages) * 8;
  static_assert(kSmem <= 232448, "tiles exceed the shared memory of a block");
};

// consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
template <int DP>
__device__ __forceinline__ void dq_consume(const Params& p, uint8_t* qs,
                                           uint8_t* os, uint8_t* ks,
                                           uint8_t* vs, uint64_t* q_full,
                                           uint64_t* k_full,
                                           uint64_t* k_empty,
                                           uint64_t* v_full,
                                           uint64_t* v_empty, int q0, int h,
                                           int b, int wg, int first,
                                           int last) {
  using Sh = DqShape<DP>;
  constexpr int kChunks = Sh::kChunks;
  const int tid = threadIdx.x % 128;
  const int t = tid % 4;
  const int wq0 = q0 + wg * 64;   // the warpgroup's first row
  const int row0 = wq0 + (tid / 32) * 16 + (tid % 32) / 4;   // and row0 + 8
  const uint32_t q_addr = smem_u32(qs) + wg * kBox;
  const uint32_t o_addr = smem_u32(os) + wg * kBox;

  float lse2[2], di[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + 8 * rr;
    const long long at = (static_cast<long long>(b) * p.H + h) * p.S + r;
    // rows past S: P = exp2(x − inf) = 0
    lse2[rr] = r < p.S ? p.lse[at] * kLog2e : INFINITY;
    di[rr] = r < p.S ? p.di[at] : 0.f;
  }
  float dq[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;

  // acc (+)= A·Bᵀ, A the warpgroup's 64 rows of Q or dO, B a K or V tile
  auto rows_x_keys = [&](float (&acc)[32], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t a_off = (kk / 4) * kDqRows * 128 + (kk % 4) * 32;
      const uint32_t b_off = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_ss(acc, sw128_desc(a_addr + a_off), sw128_desc(b_addr + b_off),
               kk > 0);
    }
    wgmma_commit();
  };

  mbar_wait(q_full, 0);   // also when the walk is empty: no copy outlives us
  for (int it = 0; it < last - first; ++it) {
    const int sk = it % Sh::kKStages;
    const int sv = it % Sh::kVStages;
    const int k_phase = (it / Sh::kKStages) & 1;
    const int v_phase = (it / Sh::kVStages) & 1;
    const int k0 = (first + it) * 64;
    const uint32_t k_addr = smem_u32(ks + sk * Sh::kTileBytes);
    const uint32_t v_addr = smem_u32(vs + sv * Sh::kTileBytes);
    mbar_wait(&k_full[sk], k_phase);

    // S = Q·Kᵀ and dP = dO·Vᵀ (64 rows x 64 keys); with kOverlap two
    // groups, so that P is computed while dP runs
    float s[32], dp[32];
    if constexpr (Sh::kOverlap) mbar_wait(&v_full[sv], v_phase);
    wgmma_fence();
    rows_x_keys(s, q_addr, k_addr);
    if constexpr (Sh::kOverlap) {
      rows_x_keys(dp, o_addr, v_addr);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }

    // P, then dS = P ∘ (dP − Dᵢ), in place of s; every exponential is
    // computed, then selected, so the loop has no branch
    if (tile_needs_mask(p, wq0, 64, k0, 64)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int rr = (i >> 1) & 1;
        const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        const float e = fast_exp2(s[i] * p.scale_log2 - lse2[rr]);
        s[i] = visible(p, row0 + 8 * rr, col) ? e : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = fast_exp2(s[i] * p.scale_log2 - lse2[(i >> 1) & 1]);
    }
    // dS = P ∘ (dP − Dᵢ), packed to bf16 pairs (word j: elements 2j, 2j + 1)
    uint32_t w[16];
    if constexpr (Sh::kOverlap) {
      wgmma_wait<0>();
      mbar_arrive(&v_empty[sv]);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        w[j] = pack_bf16(s[2 * j] * (dp[2 * j] - di[j & 1]),
                         s[2 * j + 1] * (dp[2 * j + 1] - di[j & 1]));
    } else {
      // P to bf16 first, so that its fp32 tile is dead while dP runs
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
      mbar_wait(&v_full[sv], v_phase);
      wgmma_fence();
      rows_x_keys(dp, o_addr, v_addr);
      wgmma_wait<0>();
      mbar_arrive(&v_empty[sv]);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        w[j] = pack_bf16(bf16_lo(w[j]) * (dp[2 * j] - di[j & 1]),
                         bf16_hi(w[j]) * (dp[2 * j + 1] - di[j & 1]));
    }

    // dQ += dS·K, 16 keys a step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {w[4 * kk], w[4 * kk + 1], w[4 * kk + 2],
                             w[4 * kk + 3]};
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        wgmma_rs_tb(dq[c], a, sw128_desc(k_addr + c * kBox + kk * 2048));
    }
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(&k_empty[sk]);
  }
  store_rows<kChunks>(dq,
                      static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb +
                          h * p.dq_sh,
                      p.dq_ss, row0, p.S, p.D, p.scale);
}

template <int DP>
__global__ void __launch_bounds__(DqShape<DP>::kThreadsAll, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ Maps maps, const Params p) {
  using Sh = DqShape<DP>;
  constexpr int kChunks = Sh::kChunks;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);   // [chunk][128][64]
  uint8_t* os = qs + Sh::kQBytes;
  constexpr int kKStages = Sh::kKStages;
  constexpr int kVStages = Sh::kVStages;
  uint8_t* ks = os + Sh::kQBytes;      // [stage][chunk][64][64]
  uint8_t* vs = ks + kKStages * Sh::kTileBytes;
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(vs + kVStages * Sh::kTileBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kKStages;
  uint64_t* v_full = k_empty + kKStages;
  uint64_t* v_empty = v_full + kVStages;

  // query tiles vary slowest and run from the last, the one with the most
  // kv tiles under causal
  const int nb = p.H * p.B;
  const int n_tiles = (p.S + kDqRows - 1) / kDqRows;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.x) / nb) * kDqRows;
  const int h = (blockIdx.x % nb) % p.H;
  const int b = (blockIdx.x % nb) / p.H;
  int first, last;
  kv_tile_range(p, q0, kDqRows, 64, &first, &last);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 256);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // 40 + 2 x 232 registers a thread fit the register file
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 == 0) {
      const int kvh = h / p.G;
      mbar_expect_tx(q_full, 2 * Sh::kQBytes);
      for (int c = 0; c < kChunks; ++c)
        for (int r = 0; r < 2; ++r) {
          const int at = c * kDqRows * 128 + r * kBox;
          tma_load(qs + at, &maps.q, q_full, c * 64, h, q0 + r * 64, b);
          tma_load(os + at, &maps.dout, q_full, c * 64, h, q0 + r * 64, b);
        }
      for (int it = 0; it < last - first; ++it) {
        const int sk = it % kKStages;
        const int sv = it % kVStages;
        const int k0 = (first + it) * 64;
        if (it >= kKStages)
          mbar_wait(&k_empty[sk], ((it / kKStages) & 1) ^ 1);
        mbar_expect_tx(&k_full[sk], Sh::kTileBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load(ks + sk * Sh::kTileBytes + c * kBox, &maps.k, &k_full[sk],
                   c * 64, kvh, k0, b);
        if (it >= kVStages)
          mbar_wait(&v_empty[sv], ((it / kVStages) & 1) ^ 1);
        mbar_expect_tx(&v_full[sv], Sh::kTileBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load(vs + sv * Sh::kTileBytes + c * kBox, &maps.v, &v_full[sv],
                   c * 64, kvh, k0, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    dq_consume<DP>(p, qs, os, ks, vs, q_full, k_full, k_empty, v_full,
                   v_empty, q0, h, b, wg, first, last);
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

cudaError_t launch_dot(const Params& p, int is_bf16, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.B) * p.S * p.H;
  if (is_bf16)
    flash_bwd_dot<__nv_bfloat16><<<(rows + 7) / 8, 256, 0, stream>>>(p);
  else
    flash_bwd_dot<float><<<(rows + 7) / 8, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename K>
cudaError_t launch_wgmma(K kernel, long long blocks, int threads, int bytes,
                         const Maps& maps, const Params& p,
                         cudaStream_t stream) {
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, bytes, stream>>>(maps, p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16(const Maps& maps, const Params& p,
                        cudaStream_t stream) {
  const long long key_blocks =
      static_cast<long long>((p.T + 63) / 64) * p.KV * p.B;
  cudaError_t err;
  if constexpr (DP > 128)
    err = launch_wgmma(flash_bwd_dkdv_split_wgmma<DP>, key_blocks,
                       DkdvSplitShape<DP>::kThreadsAll,
                       DkdvSplitShape<DP>::kSmem, maps, p, stream);
  else
    err = launch_wgmma(flash_bwd_dkdv_wgmma<DP>, key_blocks,
                       DkdvShape<DP>::kThreadsAll, DkdvShape<DP>::kSmem,
                       maps, p, stream);
  if (err != cudaSuccess) return err;
  return launch_wgmma(
      flash_bwd_dq_wgmma<DP>,
      static_cast<long long>((p.S + kDqRows - 1) / kDqRows) * p.H * p.B,
      DqShape<DP>::kThreadsAll, DqShape<DP>::kSmem, maps, p, stream);
}

template <int DP>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  cudaError_t err = launch_one(flash_bwd_dkdv_f32<DP>,
                               dim3((p.T + kS - 1) / kS, p.KV, p.B), 128,
                               f32_smem_bytes<DP>(), p, stream);
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
// dims: B, S, T, H, KV, D (a multiple of 8 up to 256), causal, window (0:
// none), is_bf16.  Launches
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
      p.D < 8 || p.D > 256 || p.D % 8 != 0 || p.B > 65535 || p.H > 65535 ||
      p.window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.G = p.H / p.KV;
  p.scale = static_cast<float>(1.0 / std::sqrt(double(p.D)));
  p.scale_log2 = static_cast<float>(1.4426950408889634 / std::sqrt(double(p.D)));
  cudaError_t err = launch_dot(p, is_bf16, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (is_bf16) {
    Maps maps;
    if (!encode_map(&maps.q, p.q, p.B, p.S, p.H, p.D, p.q_sb, p.q_ss,
                    p.q_sh) ||
        !encode_map(&maps.k, p.k, p.B, p.T, p.KV, p.D, p.k_sb, p.k_st,
                    p.k_sh) ||
        !encode_map(&maps.v, p.v, p.B, p.T, p.KV, p.D, p.v_sb, p.v_st,
                    p.v_sh) ||
        !encode_map(&maps.dout, p.dout, p.B, p.S, p.H, p.D, p.do_sb,
                    p.do_ss, p.do_sh))
      return static_cast<int>(cudaErrorInvalidValue);
    err = p.D <= 64    ? launch_bf16<64>(maps, p, stream)
          : p.D <= 128 ? launch_bf16<128>(maps, p, stream)
                       : launch_bf16<256>(maps, p, stream);
  } else if (p.D <= 32) {
    err = launch_f32<32>(p, stream);
  } else if (p.D <= 64) {
    err = launch_f32<64>(p, stream);
  } else if (p.D <= 128) {
    err = launch_f32<128>(p, stream);
  } else {
    err = launch_f32<256>(p, stream);
  }
  return static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
