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
// at 3.35 TB/s): the tensor cores, not memory, bound it, and only `wgmma`
// reaches their full rate.
//
// Design.  The TPU kernel runs the kv axis as a sequential grid dimension
// with m, l and acc in VMEM scratch carried across it.  Blocks here run in
// parallel and carry nothing, so one block owns a tile of query rows of one
// (b, h) and loops over the kv tiles itself, the online softmax in
// registers.  KV tiles that the causal mask or the window hides from every
// row of the block are never visited (the TPU kernel's `run` predicate),
// and the mask is evaluated only on tiles that straddle its edge.  Blocks
// start from the last query tile, the one with the most kv tiles under a
// causal mask.
//
// * bf16 (`flash_fwd_wgmma`), warp-specialised: a producer and one or two
//   consumer warpgroups of 64 query rows each (`q_block` 64 or 128).  At
//   two, the producer is a whole warpgroup that hands registers to the
//   consumers (`setmaxnreg`: ptxas caps a 288-thread block at 168 a
//   thread), else one warp.
//   The producer's elected lane brings the block's q rows once and every
//   K and V tile (`kv_block` 64 or 128 keys) by TMA into a two-stage ring
//   in shared memory, K and V of a stage on separate mbarriers, so S can
//   start before V lands; consumers free a stage through a third mbarrier.
//   TMA writes each 64-column slice of a tile in the 128-byte swizzled
//   layout that `wgmma` reads, and zero-fills what lies past S, T and D
//   (D is padded to 64 or 128).  S = q·kᵀ is `wgmma.mma_async`
//   m64nBNk16 with both operands in shared memory (K-major); the online
//   softmax runs on the accumulators in registers, in log2 units; P is
//   rounded to bf16 in registers and is the A operand of P·V (m64n64k16
//   a 64-column slice of D), V the B operand read from shared memory in
//   its own (key-row) layout through the transpose flag, all accumulation
//   fp32.  Each warpgroup keeps two score buffers and issues the next
//   tile's S before the softmax of this one, so the tensor cores work
//   while the CUDA cores exponentiate; the two warpgroups of a 128-row
//   block also run out of step.  Inputs whose strides TMA cannot describe
//   are copied by the wrapper first.
// * bf16 at head dim 256 (gemma3): the same kernel at D padded to 256.
//   A 64 x 256 fp32 output tile is 128 accumulator registers a consumer
//   thread, so the second score buffer goes (S of the next tile is issued
//   after this tile's p·v, not beside its softmax): 160 live accumulators
//   where the overlap would need 192 beside the addressing.  Q of 128 rows
//   is 64 KB and a K or V tile of 64 keys 32 KB, so two stages of 64-key
//   tiles fit (197 KB at 128 rows) and 128-key tiles do not: kv_block is
//   64 only.  At 128 rows the producer warpgroup hands its registers over
//   (`setmaxnreg` 40 / 232) as at D 128; the wrapper's default there, as
//   its two warpgroups overlap one another's softmax and products.
// * The elementwise step takes the backward's two idioms: the
//   exponential is `ex2.approx.ftz` on every element (a masked score is
//   -inf, whose 2^x is 0), and shared-memory pointers are offsets from the
//   `extern __shared__` array, so reads stay shared loads.
// * fp32 (`flash_fwd_f32`): plain FMA, not TF32, so that it holds to the
//   plain fp32 version at 1e-5.  4 warps, 32 query rows, kv tiles of 32;
//   four threads share a row, each scoring 8 keys and accumulating a
//   quarter of the output columns.  It has one launch shape and ignores
//   q_block and kv_block; at D 256 a block holds 101 KB of tiles.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cmath>

#include "hopper_common.cuh"

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
// bf16: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

constexpr int kStages = 2;

template <int DP, int BM, int BN>
struct FwdShape {
  static constexpr int kChunks = DP / 64;      // 64-column slices of D
  static constexpr int kWG = BM / 64;          // consumer warpgroups
  // and the producer: a whole warpgroup at two consumer warpgroups, so
  // that it can hand its registers to them, else one warp
  static constexpr int kThreadsAll = kWG * 128 + (kWG == 2 ? 128 : 32);
  static constexpr int kQBytes = kChunks * BM * 128;
  static constexpr int kTileBytes = kChunks * BN * 128;   // one K or V tile
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes +
                               (1 + 3 * kStages) * 8;
  // S of the next tile beside this tile's softmax: a second score buffer,
  // which a 64 x 256 output tile leaves no registers for
  static constexpr bool kOverlap = DP <= 128;
  static_assert(kSmem <= 232448, "tiles exceed the shared memory of a block");
};

struct Maps {
  CUtensorMap q, k, v;
};

template <int DP, int BM, int BN>
__device__ __forceinline__ void consume(const Params& p, uint8_t* qs,
                                        uint8_t* ks, uint8_t* vs,
                                        uint64_t* q_full, uint64_t* k_full,
                                        uint64_t* v_full, uint64_t* empty,
                                        int q0, int h, int b, int wg,
                                        int first, int last);

template <int DP, int BM, int BN>
__global__ void __launch_bounds__(FwdShape<DP, BM, BN>::kThreadsAll, 1)
    flash_fwd_wgmma(const __grid_constant__ Maps maps, const Params p) {
  using Sh = FwdShape<DP, BM, BN>;
  constexpr int kChunks = Sh::kChunks;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);   // [chunk][BM][64], swizzled tiles
  uint8_t* ks = qs + Sh::kQBytes;                   // [stage][chunk][BN][64]
  uint8_t* vs = ks + kStages * Sh::kTileBytes;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(vs + kStages * Sh::kTileBytes);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  int first, last;
  kv_tile_range(p, q0, BM, BN, &first, &last);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], Sh::kWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform for the compiler (a shuffle result), so the wgmma below
  // are not taken to sit on a divergent path
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == Sh::kWG) {
    // producer: gives its registers to the consumers (a whole warpgroup);
    // one thread issues every copy
    if constexpr (Sh::kWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 == 0) {
      const int kvh = h / p.G;
      mbar_expect_tx(q_full, Sh::kQBytes);
      for (int c = 0; c < kChunks; ++c)
        for (int r = 0; r < BM / 64; ++r)
          tma_load(qs + c * BM * 128 + r * kBox, &maps.q, q_full, c * 64, h,
                   q0 + r * 64, b);
      for (int it = 0; it < last - first; ++it) {
        const int st = it % kStages;
        const int k0 = (first + it) * BN;
        if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        uint8_t* kt = ks + st * Sh::kTileBytes;
        uint8_t* vt = vs + st * Sh::kTileBytes;
        mbar_expect_tx(&k_full[st], Sh::kTileBytes);
        for (int c = 0; c < kChunks; ++c)
          for (int r = 0; r < BN / 64; ++r)
            tma_load(kt + c * BN * 128 + r * kBox, &maps.k, &k_full[st],
                     c * 64, kvh, k0 + r * 64, b);
        mbar_expect_tx(&v_full[st], Sh::kTileBytes);
        for (int c = 0; c < kChunks; ++c)
          for (int r = 0; r < BN / 64; ++r)
            tma_load(vt + c * BN * 128 + r * kBox, &maps.v, &v_full[st],
                     c * 64, kvh, k0 + r * 64, b);
      }
    }
  } else {
    // 3 x 128 threads start at 168 registers each; 40 + 2 x 232 fit the
    // register file (one block of 128 rows a multiprocessor)
    if constexpr (Sh::kWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<DP, BM, BN>(p, qs, ks, vs, q_full, k_full, v_full, empty, q0, h,
                        b, wg, first, last);
  }
}

// consumer warpgroup wg: query rows q0 + 64 wg + [0, 64)
template <int DP, int BM, int BN>
__device__ __forceinline__ void consume(const Params& p, uint8_t* qs,
                                        uint8_t* ks, uint8_t* vs,
                                        uint64_t* q_full, uint64_t* k_full,
                                        uint64_t* v_full, uint64_t* empty,
                                        int q0, int h, int b, int wg,
                                        int first, int last) {
  using Sh = FwdShape<DP, BM, BN>;
  constexpr int kChunks = Sh::kChunks;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row[2] = {q0 + wg * 64 + warp * 16 + g,
                      q0 + wg * 64 + warp * 16 + g + 8};
  const int wq0 = q0 + wg * 64;   // the warpgroup's first row
  const uint32_t q_addr = smem_u32(qs) + wg * kBox;

  float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
  float l[2] = {0.f, 0.f};               // this thread's share of the sum
  float o[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;

  // S = q·kᵀ of tile `it` into `acc`, issued and committed, not waited for
  auto issue_s = [&](float (&acc)[BN / 2], int it) {
    const int st = it % kStages;
    mbar_wait(&k_full[st], (it / kStages) & 1);
    const uint32_t k_addr = smem_u32(ks + st * Sh::kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss(acc, sw128_desc(q_addr + (kk / 4) * BM * 128 + (kk % 4) * 32),
               sw128_desc(k_addr + (kk / 4) * BN * 128 + (kk % 4) * 32),
               kk > 0);
    wgmma_commit();
  };

  // two score buffers (kOverlap): S of the next tile runs on the tensor
  // cores while the softmax of this one runs on the CUDA cores
  float s[BN / 2], s_next[BN / 2];
  const int n_tiles = last - first;
  mbar_wait(q_full, 0);
  if (n_tiles > 0) {
    issue_s(s, 0);
    wgmma_wait<0>();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int k0 = (first + it) * BN;
    if (Sh::kOverlap && it + 1 < n_tiles) issue_s(s_next, it + 1);

    const bool masked = tile_needs_mask(p, wq0, 64, k0, BN);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      float x = s[i] * p.scale_log2;
      const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      if (masked && !visible(p, row[(i >> 1) & 1], col)) x = -INFINITY;
      s[i] = x;
    }

    // online softmax, rows g and g + 8 (four lanes share a row)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * rr], s[4 * j + 2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = fast_exp2(m[rr] - m_use);
      m[rr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float& e0 = s[4 * j + 2 * rr];
        float& e1 = s[4 * j + 2 * rr + 1];
        e0 = fast_exp2(e0 - m_use);
        e1 = fast_exp2(e1 - m_use);
        sum += e0 + e1;
      }
      l[rr] = l[rr] * corr + sum;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[c][4 * j + 2 * rr] *= corr;
          o[c][4 * j + 2 * rr + 1] *= corr;
        }
    }

    // o += p·v: p (bf16) from registers, 16 keys a step
    mbar_wait(&v_full[st], (it / kStages) & 1);
    const uint32_t v_addr = smem_u32(vs + st * Sh::kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[8 * kk], s[8 * kk + 1]),
                             pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                             pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                             pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        wgmma_rs_tb(o[c], a, sw128_desc(v_addr + c * BN * 128 + kk * 2048));
    }
    wgmma_commit();
    wgmma_wait<0>();   // this tile's p·v (and the next tile's S)
    mbar_arrive(&empty[st]);
    if constexpr (Sh::kOverlap) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = s_next[i];
    } else if (it + 1 < n_tiles) {
      issue_s(s, it + 1);
      wgmma_wait<0>();
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
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * 64 + 8 * j + 2 * t;
        if (col < p.D)   // D is a multiple of 8: the pair is in or out
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[c][4 * j + 2 * rr] * inv_l,
                                    o[c][4 * j + 2 * rr + 1] * inv_l);
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
    const float corr = fast_exp2(m - m_use);
    m = m_new;
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float e = fast_exp2(s[jj] - m_use);
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

template <int DP, int BM, int BN>
cudaError_t launch_wgmma(const Maps& maps, const Params& p, int B,
                         cudaStream_t stream) {
  using Sh = FwdShape<DP, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<DP, BM, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + BM - 1) / BM, p.H, B);
  flash_fwd_wgmma<DP, BM, BN>
      <<<grid, Sh::kThreadsAll, Sh::kSmem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16(const Maps& maps, const Params& p, int B, int q_block,
                        int kv_block, cudaStream_t stream) {
  if constexpr (DP == 256) {   // 128-key tiles do not fit two stages
    return q_block == 64 ? launch_wgmma<DP, 64, 64>(maps, p, B, stream)
                         : launch_wgmma<DP, 128, 64>(maps, p, B, stream);
  } else {
    if (q_block == 64)
      return kv_block == 64 ? launch_wgmma<DP, 64, 64>(maps, p, B, stream)
                            : launch_wgmma<DP, 64, 128>(maps, p, B, stream);
    return kv_block == 64 ? launch_wgmma<DP, 128, 64>(maps, p, B, stream)
                          : launch_wgmma<DP, 128, 128>(maps, p, B, stream);
  }
}

template <int DP>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = f32_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + kSM - 1) / kSM, p.H, B);
  flash_fwd_f32<DP><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, S, H, D); k, v: (B, T, KV, D); o: (B, S, H, D), all of one dtype
// (fp32, or bf16 when is_bf16), strides in elements, the last dimension
// contiguous; lse: (B, H, S) fp32 contiguous.  window 0 means none.
// D is a multiple of 8 up to 256.  q_block and kv_block (64 or 128; kv_block
// 64 at D > 128) are the bf16 kernel's launch shape; for bf16 every pointer
// is 16-byte aligned and every stride a multiple of 8.
// Returns the launch's cudaError_t (0 on success) without synchronising.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, long long q_sb, long long q_ss,
                           long long q_sh, long long k_sb, long long k_st,
                           long long k_sh, long long v_sb, long long v_st,
                           long long v_sh, long long o_sb, long long o_ss,
                           long long o_sh, int B, int S, int T, int H, int KV,
                           int D, int causal, int window, int is_bf16,
                           int q_block, int kv_block, cudaStream_t stream) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 || D < 8 || D > 256 ||
      D % 8 != 0 || B > 65535 || H > 65535 || window < 0 ||
      (q_block != 64 && q_block != 128) ||
      (kv_block != 64 && kv_block != 128) || (D > 128 && kv_block != 64))
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
  cudaError_t err;
  if (is_bf16) {
    Maps maps;
    if (!encode_map(&maps.q, q, B, S, H, D, q_sb, q_ss, q_sh) ||
        !encode_map(&maps.k, k, B, T, KV, D, k_sb, k_st, k_sh) ||
        !encode_map(&maps.v, v, B, T, KV, D, v_sb, v_st, v_sh))
      return static_cast<int>(cudaErrorInvalidValue);
    err = D <= 64    ? launch_bf16<64>(maps, p, B, q_block, kv_block, stream)
          : D <= 128 ? launch_bf16<128>(maps, p, B, q_block, kv_block, stream)
                     : launch_bf16<256>(maps, p, B, q_block, kv_block, stream);
  } else if (D <= 32) {
    err = launch_f32<32>(p, B, stream);
  } else if (D <= 64) {
    err = launch_f32<64>(p, B, stream);
  } else if (D <= 128) {
    err = launch_f32<128>(p, B, stream);
  } else {
    err = launch_f32<256>(p, B, stream);
  }
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
