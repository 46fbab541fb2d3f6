// Paged flash-decode attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel `paged_attention_kernel` (body
// `_paged_kernel`) of src/repro/kernels/paged_attention/kernel.py: one query
// token per slot attends over that slot's K/V pages in place in the shared
// pool (P, KV, page_size, D), resolving logical page j of slot b to
// physical page pages[b, j] inside the kernel.  Two passes:
//
//   split pass  -> per-split partials (acc_s, m_s, l_s), fp32;
//   merge pass  -> the log-sum-exp merge of the splits into the
//                  unnormalised (acc, m, l) the Pallas kernel emits, or,
//                  given the current token's kt/vt, the merge of that self
//                  term too and the normalised (B, 1, H, D) output in q's
//                  dtype (what the wrapper returns; the delta-cache
//                  contract holds: kt/vt are not in the pool yet).
//
// Bound.  The work is 4*G*D operations per K/V row of 2*D elements, about
// six per byte: far below the card's balance point, so the kernel is bound
// by the K/V page bytes it must read (7.9 MB at qwen2-1.5b's decode shape,
// 2.4 us at 3.35 TB/s) and tensor cores would buy nothing.  The first
// version (one block per (slot, kv head), 2*B = 16 blocks for 132 SMs;
// each page staged by 2-byte loads widened to fp32, then four barrier
// phases per page with nothing in flight) ran 550x its bound.
//
// Split pass design.  A block owns (slot b, kv head h, split s) and walks
// logical pages [s*pps, (s+1)*pps) (split-K flash-decode: the grid comes
// from n_pages, never from the lengths, which stay on the device).  Pages
// that cannot hold a visible position are skipped exactly as the Pallas
// kernel skips them (j*ps >= kv_len, or with a window (j+1)*ps - 1 <
// kv_len + 1 - window); the running pages of a slot are one contiguous
// range, and a block with none of them writes an empty partial (m =
// NEG_INF, l = 0, acc = 0) and exits.  The block first issues its
// independent loads together (the length, the split's page ids into
// shared memory, q's rows), so that no page copy waits on a table load.
// Pages are staged in the pool's dtype by 16-byte cp.async.cg copies into
// a ring of up to three stages, two pages in flight while the third is
// consumed, one barrier a page.  The trash page (physical page 0, NaN in
// every test) is read as zeros by the zero-fill form of cp.async (source
// size 0): its bytes are never loaded, so zeros come by select, never by a
// product.  Where 16-byte copies do not fit (D*elt not a multiple of 16,
// or a pointer not 16-byte aligned) the same loop stages with scalar
// loads.
//
// Arithmetic is fp32 on CUDA cores.  q is scaled and rounded to its own
// dtype as it is read (float(q)*scale, rounded, widened: the wrapper's
// order), so the wrapper does no eager work.  Each position is taken by a
// group of LPR lanes (LPR = the power of two >= D/VEC, at most 32): the
// lanes split q.k over D and reduce it by xor shuffles, two positions at a
// time (the first level trades halves, so each lane sums one of them);
// every group keeps its own online-softmax state (m, l in registers, acc
// for its column slice of D in registers, VEC columns a lane) over the
// positions it takes, two positions a softmax update, in log2 units (q
// carries log2(e), so exp2 replaces exp; m goes back to natural units on
// output); acc is rescaled only when a maximum moves, and p stays fp32
// for P.V.  At the end the groups of a warp merge by
// shuffles, the warps through shared memory (aliasing the drained ring),
// and the block writes its split's partial.  A block holds GB = 6 or 8
// query rows of the group (more rows: more blocks; fewer: the rest
// masked) and a slice of LPR*VEC
// columns of D (wider heads: more blocks, each reading the whole K row for
// q.k).  Measured on an H100, the page bytes cost next to nothing: the
// instructions a group spends on a position (q.k, its shuffle reduction,
// the softmax update) and the fixed cost of a block set the time.
//
// Pool type.  The pages (and the current token's kt, vt) come in q's
// dtype, or as float8 e4m3 under a bf16 or fp32 q (llama3-405b's
// kv_cache_dtype): the split and merge passes take the pool type P apart
// from q's type T.  An e4m3 page is staged by the same 16-byte cp.async
// copies, 16 elements a copy where bf16 has 8, half the page bytes, and
// widened in registers by cvt.rn.f16x2.e4m3x2 and then to fp32 (exact:
// every e4m3 value is an fp16 value, NaN stays NaN).  A lane still takes
// 8 columns of a row (VEC 8, as bf16), so its registers are bf16's.  The
// arithmetic per position is unchanged, so at llama3's G 16 (about 32
// fp32 operations a pool byte) halving the bytes should move the time
// little.  The reference sends f8 pools to its plain path instead
// (src/repro/kernels/paged_attention/ops.py).
//
// Merge pass: one block per (b, h, g); warp w merges splits w, w+4, ...
// (several splits' loads in flight), the warps meet in shared memory.  It
// is launched as a programmatic dependent of the split pass, so its launch
// and its reads of q and kt overlap the split pass.
// All-empty rows (a free slot, kv_len 0) stay m = NEG_INF, l = 0, acc = 0:
// NEG_INF is finite, so exp(m_s - m) is exp(0) there and never 0/0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 3;  // ring stages: pages in flight + 1
constexpr size_t kMaxSmem = 232448;  // a block's share of an SM on Hopper
// query rows a block at most; a group with more rows takes more blocks,
// which share its kv head's pages through L2
constexpr int kMaxRows = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// one float8 e4m3 element (the pools' bytes, read raw)
struct e4m3 {
  __nv_fp8_storage_t x;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(e4m3 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.x, __NV_E4M3)));
}
// two e4m3 (low byte first) to fp32, by one cvt.rn.f16x2.e4m3x2
__device__ __forceinline__ float2 e4m3x2_to_float2(unsigned short x) {
  return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(x, __NV_E4M3)));
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// float(q) * scale, rounded to q's dtype and widened again
template <typename T>
__device__ __forceinline__ float scaled_q(T x, float scale) {
  return to_f32(from_f32<T>(to_f32(x) * scale));
}

// VEC consecutive elements of T from shared memory, widened to fp32
// (aligned to VEC elements, 16 bytes at most)
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(VEC % 4 == 0, "16-byte pieces of fp32");
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  } else if constexpr (sizeof(T) == 2) {
    static_assert(VEC == 8, "16 bytes of bf16");
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    static_assert(VEC == 8, "8 bytes of e4m3");
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const unsigned short* h = reinterpret_cast<const unsigned short*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = e4m3x2_to_float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// VEC consecutive fp32 from shared memory (16-byte aligned when VEC >= 4)
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
  if constexpr (VEC == 1) {
    v[0] = p[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  }
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Programmatic dependent launch (Hopper): the merge pass is launched while
// the split pass runs, reads what does not depend on it (q, kt), then
// waits for the split pass's grid to finish and its writes to show.
__device__ __forceinline__ void grid_dep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// 2^x by the special-function unit (relative error about 2^-22; 0 for
// the NEG_INF differences)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Running pages of a slot: [j_min, j_end).  j*ps < len, and with a window
// (j+1)*ps - 1 >= len + 1 - window.
__device__ __forceinline__ void running_pages(int len, int ps, int n_pages,
                                              int window, int* j_min,
                                              int* j_end) {
  *j_end = min(n_pages, (len + ps - 1) / ps);
  int lo = 0;
  if (window > 0) {
    const int x = len + 2 - window;  // (j+1)*ps >= x
    lo = x <= 0 ? 0 : (x + ps - 1) / ps - 1;
  }
  *j_min = lo;
}

struct SplitArgs {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int32_t* pages;
  const int32_t* kv_len;
  float* acc_p;    // (B, KV, n_split, G, D)
  float* m_p;      // (B, KV, n_split, G)
  float* l_p;
  int KV, G, D, ps, n_pages, window, pps, n_split;
  float scale;
  int n_gb, n_ds, lpr, n_chunk, n_stages;
};

// Stage physical page pid of kv head h into ring stage `st` (K then V),
// in the pool's type P: by 16-byte copies (16 / sizeof(P) elements) when
// VEC > 1, else element by element.
template <typename P, int VEC>
__device__ __forceinline__ void stage_page(const SplitArgs& a, P* ring,
                                           int st, int h, int pid) {
  const int page = a.ps * a.D;
  P* ks = ring + (size_t)st * 2 * page;
  P* vs = ks + page;
  const size_t base = ((size_t)pid * a.KV + h) * page;
  const P* kg = static_cast<const P*>(a.k_pool) + base;
  const P* vg = static_cast<const P*>(a.v_pool) + base;
  if constexpr (VEC > 1) {
    constexpr int SV = 16 / sizeof(P);  // elements a 16-byte piece
    const int n16 = page / SV;
    const int nbytes = pid != 0 ? 16 : 0;  // trash page: zero fill
    for (int i = threadIdx.x; i < n16; i += kThreads) {
      cp_async16(ks + i * SV, kg + i * SV, nbytes);
      cp_async16(vs + i * SV, vg + i * SV, nbytes);
    }
  } else {
    for (int i = threadIdx.x; i < page; i += kThreads) {
      P kx{}, vx{};
      if (pid != 0) {  // trash page: zeros by select
        kx = kg[i];
        vx = vg[i];
      }
      ks[i] = kx;
      vs[i] = vx;
    }
  }
}

// This lane's share of q.k of position t of the staged page for the
// block's GB query rows, in log2 units (q_l2 carries log2(e)); 0 where
// the position is not visible.
template <typename T, typename P, int VEC, int GB>
__device__ __forceinline__ void partial_score(const P* ks, const T* q_raw,
                                              const float (&q_l2)[GB][VEC],
                                              int t, bool ok, int D, int lig,
                                              int LPR, int n_chunk,
                                              float scale, float (&sc)[GB]) {
#pragma unroll
  for (int g = 0; g < GB; ++g) sc[g] = 0.f;
  if (!ok || lig >= n_chunk) return;
  float kv[VEC];
  load_vec<P, VEC>(ks + (size_t)t * D + lig * VEC, kv);
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) sc[g] = fmaf(q_l2[g][e], kv[e], sc[g]);
  for (int c = lig + LPR; c < n_chunk; c += LPR) {  // heads wider than 32
    load_vec<P, VEC>(ks + (size_t)t * D + c * VEC, kv);  // chunks
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float qv[VEC];
      load_vec<T, VEC>(q_raw + (size_t)g * D + c * VEC, qv);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sc[g] = fmaf(to_f32(from_f32<T>(qv[e] * scale)) * kLog2e, kv[e],
                     sc[g]);
    }
  }
}

// Sum the partial scores of a group's two positions over its LPR lanes.
// The first level trades halves, so the lower lanes carry position a and
// the upper ones position b down the remaining levels, and a last swap
// gives every lane both sums: 1 + log2(LPR) shuffles a row, not
// 2*log2(LPR).  Every lane of the warp calls it.
template <int GB>
__device__ __forceinline__ void sum_pair(float (&sa)[GB], float (&sb)[GB],
                                         int lig, int LPR) {
  if (LPR == 1) return;
  const int o0 = LPR >> 1;
  const bool hi = lig & o0;
  float mine[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g)
    mine[g] = (hi ? sb[g] : sa[g]) +
              __shfl_xor_sync(0xffffffffu, hi ? sa[g] : sb[g], o0);
  for (int o = o0 >> 1; o > 0; o >>= 1)
#pragma unroll
    for (int g = 0; g < GB; ++g)
      mine[g] += __shfl_xor_sync(0xffffffffu, mine[g], o);
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const float other = __shfl_xor_sync(0xffffffffu, mine[g], o0);
    sa[g] = hi ? other : mine[g];
    sb[g] = hi ? mine[g] : other;
  }
}

template <typename T, typename P, int VEC, int GB>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const SplitArgs a) {
  const int s = blockIdx.x;
  const int b = blockIdx.z;
  const int ds = blockIdx.y % a.n_ds;
  const int gb = (blockIdx.y / a.n_ds) % a.n_gb;
  const int h = blockIdx.y / (a.n_ds * a.n_gb);
  const int tid = threadIdx.x;
  const int D = a.D, ps = a.ps, G = a.G;
  const int g0 = gb * GB;
  const int rows = min(GB, G - g0);
  const int LPR = a.lpr;
  const int DS = LPR * VEC;  // columns of D this block accumulates
  const size_t bh = (size_t)b * a.KV + h;
  const size_t part_row = (bh * a.n_split + s) * G;  // + g

  // shared memory: q's rows as given (T), the split's page ids, then the
  // ring of staged pages (at the end, the warps' partials)
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_raw = reinterpret_cast<T*>(smem);
  const size_t q_bytes = ((size_t)GB * D * sizeof(T) + 15) / 16 * 16;
  int* pid_s = reinterpret_cast<int*>(smem + q_bytes);
  const size_t head_bytes =
      q_bytes + ((size_t)a.pps * sizeof(int) + 15) / 16 * 16;
  P* ring = reinterpret_cast<P*>(smem + head_bytes);

  // the independent loads first, so that their latencies overlap: the
  // slot's length, the split's page ids (read from shared memory when a
  // page is staged, so no page waits on a table load) and q's rows (by
  // cp.async where 16-byte copies fit; they land with the first page)
  const int len = a.kv_len[b];
  const int p0 = s * a.pps;
  const int n_tbl = min(a.pps, a.n_pages - p0);
  for (int i = tid; i < n_tbl; i += kThreads)
    pid_s[i] = a.pages[(size_t)b * a.n_pages + p0 + i];
  const T* qg = static_cast<const T*>(a.q) + (bh * G + g0) * D;
  if constexpr (VEC > 1) {
    constexpr int QV = 16 / sizeof(T);  // q's elements a 16-byte piece
    for (int i = tid; i < GB * D / QV; i += kThreads)
      cp_async16(q_raw + i * QV, i * QV < rows * D ? qg + i * QV : qg,
                 i * QV < rows * D ? 16 : 0);
  } else {
    for (int i = tid; i < GB * D; i += kThreads)
      q_raw[i] = i < rows * D ? qg[i] : from_f32<T>(0.f);
  }

  int j_min, j_end;
  running_pages(len, ps, a.n_pages, a.window, &j_min, &j_end);
  const int j_lo = max(p0, j_min);
  const int j_hi = min(p0 + a.pps, j_end);

  if (j_lo >= j_hi) {  // nothing to read: an empty partial
    cp_async_commit();  // q's copies: none left in flight at exit
    cp_async_wait<0>();
    for (int i = tid; i < rows * DS; i += kThreads) {
      const int g = i / DS, d = ds * DS + i % DS;
      if (d < D) a.acc_p[(part_row + g0 + g) * D + d] = 0.f;
    }
    if (ds == 0)
      for (int g = tid; g < rows; g += kThreads) {
        a.m_p[part_row + g0 + g] = kNegInf;
        a.l_p[part_row + g0 + g] = 0.f;
      }
    return;
  }
  const int NS = a.n_stages;
  __syncthreads();  // the page ids are in shared memory

  // prologue: the first NS - 1 pages in flight (q's copies join the first
  // group)
  for (int i = 0; i < NS - 1; ++i) {
    if (j_lo + i < j_hi)
      stage_page<P, VEC>(a, ring, i, h, pid_s[j_lo + i - p0]);
    cp_async_commit();
  }

  const int grp = tid / LPR, lig = tid % LPR;
  const int n_groups = kThreads / LPR;
  const int n_chunk = a.n_chunk;
  const int cv = ds * LPR + lig;  // this lane's chunk of the column slice
  // online-softmax state of this lane's group, in log2 units
  float m[GB], l[GB], acc[GB][VEC], q_l2[GB][VEC];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const int page = ps * D;
  for (int j = j_lo; j < j_hi; ++j) {
    const int it = j - j_lo;
    if (NS >= 2) {
      if (NS == 3)  // all but the NS - 2 newest groups have landed
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // page `it` landed; stage (it - 1) % NS is free
      if (j + NS - 1 < j_hi)
        stage_page<P, VEC>(a, ring, (it + NS - 1) % NS, h,
                           pid_s[j + NS - 1 - p0]);
      cp_async_commit();
    } else {
      __syncthreads();  // the previous page's reads are done
      stage_page<P, VEC>(a, ring, 0, h, pid_s[j - p0]);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    if (it == 0) {  // q has landed: this lane's first chunk to registers,
                    // scaled, rounded to T, widened, times log2(e)
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float qv[VEC];
        if (lig < n_chunk) {
          load_vec<T, VEC>(q_raw + (size_t)g * D + lig * VEC, qv);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) qv[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          q_l2[g][e] = to_f32(from_f32<T>(qv[e] * a.scale)) * kLog2e;
      }
    }
    const P* ks = ring + (size_t)(it % NS) * 2 * page;
    const P* vs = ks + page;

    // two positions of the page a group a step, one softmax update for
    // both; the loop bounds are uniform in the warp (the shuffles)
    for (int t0 = 0; t0 < ps; t0 += 2 * n_groups) {
      const int ta = t0 + grp, tb = ta + n_groups;
      const bool act_a = ta < ps, act_b = tb < ps;
      const int pa = j * ps + ta, pb = j * ps + tb;
      const bool ok_a = act_a && pa < len &&
                        (a.window <= 0 || pa >= len + 1 - a.window);
      const bool ok_b = act_b && pb < len &&
                        (a.window <= 0 || pb >= len + 1 - a.window);
      float sa[GB], sb[GB];
      partial_score<T, P, VEC, GB>(ks, q_raw, q_l2, ta, ok_a, D, lig, LPR,
                                   n_chunk, a.scale, sa);
      partial_score<T, P, VEC, GB>(ks, q_raw, q_l2, tb, ok_b, D, lig, LPR,
                                   n_chunk, a.scale, sb);
      sum_pair<GB>(sa, sb, lig, LPR);
      float va[VEC], vb[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) va[e] = vb[e] = 0.f;
      if (cv < n_chunk) {
        if (act_a) load_vec<P, VEC>(vs + (size_t)ta * D + cv * VEC, va);
        if (act_b) load_vec<P, VEC>(vs + (size_t)tb * D + cv * VEC, vb);
      }
      // masked positions count, as NEG_INF scores; positions past the
      // page (a group with none) add nothing
      float corr[GB];
      bool moved = false;
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float xa = ok_a ? sa[g] : kNegInf;
        const float xb = ok_b ? sb[g] : kNegInf;
        const float mn = fmaxf(m[g], fmaxf(xa, xb));
        corr[g] = mn == m[g] ? 1.f : fast_exp2(m[g] - mn);
        moved |= mn != m[g];
        const float p_a = act_a ? fast_exp2(xa - mn) : 0.f;
        const float p_b = act_b ? fast_exp2(xb - mn) : 0.f;
        l[g] = fmaf(l[g], corr[g], p_a + p_b);
        m[g] = mn;
        sa[g] = p_a;
        sb[g] = p_b;
      }
      // rescale the accumulators only where a maximum moved in the warp
      // (an exact skip: the factor is 1 everywhere else)
      if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] *= corr[g];
      }
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[g][e] = fmaf(sb[g], vb[e], fmaf(sa[g], va[e], acc[g][e]));
    }
  }
  cp_async_wait<0>();
  grid_dep_launch_dependents();  // the merge pass may start its prologue

  // merge the groups of a warp (lanes lig apart by multiples of LPR hold
  // the same columns)
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float ws = exp2f(m[g] - mn), wo = exp2f(mo - mn);
      l[g] = ws * l[g] + wo * lo;
      m[g] = mn;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = ws * acc[g][e] + wo * ao;
      }
    }
  }

  // then the warps, through shared memory (the drained ring)
  __syncthreads();
  float* scr = reinterpret_cast<float*>(smem + head_bytes);
  const int stride = DS + 2;  // acc columns, then m, l
  const int warp = tid >> 5, lane = tid & 31;
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float* row = scr + ((size_t)warp * GB + g) * stride;
#pragma unroll
      for (int e = 0; e < VEC; ++e) row[lig * VEC + e] = acc[g][e];
      if (lane == 0) {
        row[DS] = m[g];
        row[DS + 1] = l[g];
      }
    }
  }
  __syncthreads();
  // each row's weights once (thread g), then the columns
  float* wts = scr + (size_t)kWarps * GB * stride;  // (GB, kWarps)
  if (tid < rows) {
    const int g = tid;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, scr[((size_t)w * GB + g) * stride + DS]);
    float lt = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* row = scr + ((size_t)w * GB + g) * stride;
      wts[g * kWarps + w] = exp2f(row[DS] - mx);
      lt = fmaf(wts[g * kWarps + w], row[DS + 1], lt);
    }
    if (ds == 0) {  // back to natural-log units
      a.m_p[part_row + g0 + g] = mx == kNegInf ? kNegInf : mx * kLn2;
      a.l_p[part_row + g0 + g] = lt;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * DS; i += kThreads) {
    const int g = i / DS, col = i % DS, d = ds * DS + col;
    if (d >= D) continue;
    float at = 0.f;
    for (int w = 0; w < kWarps; ++w)
      at = fmaf(wts[g * kWarps + w],
                scr[((size_t)w * GB + g) * stride + col], at);
    a.acc_p[(part_row + g0 + g) * D + d] = at;
  }
}

struct MergeArgs {
  const float* acc_p;
  const float* m_p;
  const float* l_p;
  int KV, G, D, n_split;
  // self term: q (B, KV, G, D) unscaled, kt (B, KV, 1, D) in the pools'
  // dtype, vt in fp32 (vt_dtype 0), bf16 (1) or e4m3 (2); out (B, 1, H,
  // D) in q's dtype.
  // kt == null: write acc (B, KV, G, D), m, l (B, KV, G) instead.
  const void* q;
  const void* kt;
  const void* vt;
  int vt_dtype;
  float scale;
  void* out;
  float* acc;
  float* m;
  float* l;
};

// Sum of v over the block; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0.f;
  for (int w = 0; w < kWarps; ++w) v += red[w];
  return v;
}

// One block per (b, h, g).  Warp w merges splits s = w, w + 4, ... by
// the log-sum-exp rule, its lanes over D in VEC-float pieces (the loads of
// several splits in flight at once); the four warps' (m, l, acc) then meet
// in shared memory.
template <typename T, typename P, int VEC>
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const MergeArgs a) {
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = a.D, G = a.G, S = a.n_split;
  const size_t bh = (size_t)b * a.KV + h;
  const size_t row = (bh * G + g) * D;  // (B, KV, G, D) and (B, 1, H, D)
  const float* mp = a.m_p + bh * S * G + g;  // split s at s * G
  const float* lp = a.l_p + bh * S * G + g;
  const float* ap = a.acc_p + (bh * S * G + g) * D;  // split s at s * G * D
  __shared__ float red[kWarps];
  __shared__ float ml[kWarps][2];
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);  // (kWarps, D)

  // the current token's score, (float(q)*scale rounded to T) . kt (in P):
  // its
  // loads go out with the partials'
  float dot = 0.f;
  if (a.kt != nullptr) {
    const T* qr = static_cast<const T*>(a.q) + row;
    const P* kr = static_cast<const P*>(a.kt) + bh * D;
    for (int d = tid; d < D; d += kThreads)
      dot = fmaf(scaled_q(qr[d], a.scale), to_f32(kr[d]), dot);
  }
  grid_dep_wait();  // the split pass has finished; its partials show

  for (int c = lane; c * VEC < D; c += 32) {
    float mw = kNegInf, lw = 0.f, aw[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) aw[e] = 0.f;
#pragma unroll 4
    for (int s = warp; s < S; s += kWarps) {
      const float ms = mp[(size_t)s * G], ls = lp[(size_t)s * G];
      float x[VEC];
      load_f32<VEC>(ap + (size_t)s * G * D + c * VEC, x);
      const float mn = fmaxf(mw, ms);
      const float c0 = expf(mw - mn), c1 = expf(ms - mn);
      lw = fmaf(lw, c0, ls * c1);
#pragma unroll
      for (int e = 0; e < VEC; ++e) aw[e] = fmaf(aw[e], c0, x[e] * c1);
      mw = mn;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) part[warp * D + c * VEC + e] = aw[e];
    if (c == 0) {
      ml[warp][0] = mw;
      ml[warp][1] = lw;
    }
  }
  __syncthreads();
  float mx = kNegInf;
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml[w][0]);
  float wt[kWarps], lt = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    wt[w] = expf(ml[w][0] - mx);
    lt = fmaf(wt[w], ml[w][1], lt);
  }

  if (a.kt == nullptr) {
    for (int d = tid; d < D; d += kThreads) {
      float at = 0.f;
      for (int w = 0; w < kWarps; ++w) at = fmaf(wt[w], part[w * D + d], at);
      a.acc[row + d] = at;
    }
    if (tid == 0) {
      a.m[bh * G + g] = mx;
      a.l[bh * G + g] = lt;
    }
    return;
  }

  const float s_self = block_sum(dot, red);

  const float m_tot = fmaxf(mx, s_self);
  const float alpha = expf(mx - m_tot);
  const float beta = expf(s_self - m_tot);
  const float l_tot = alpha * lt + beta;
  T* out = static_cast<T*>(a.out) + row;
  for (int d = tid; d < D; d += kThreads) {
    float at = 0.f;
    for (int w = 0; w < kWarps; ++w) at = fmaf(wt[w], part[w * D + d], at);
    const float v =
        a.vt_dtype == 0
            ? static_cast<const float*>(a.vt)[bh * D + d]
        : a.vt_dtype == 1
            ? __bfloat162float(
                  static_cast<const __nv_bfloat16*>(a.vt)[bh * D + d])
            : to_f32(static_cast<const e4m3*>(a.vt)[bh * D + d]);
    out[d] = from_f32<T>((alpha * at + beta * v) / l_tot);
  }
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <typename T, typename P, int VEC, int GB>
cudaError_t launch_split(SplitArgs a, int B, cudaStream_t stream) {
  const size_t head = ((size_t)GB * a.D * sizeof(T) + 15) / 16 * 16 +
                      ((size_t)a.pps * sizeof(int) + 15) / 16 * 16;
  const size_t stage = 2 * (size_t)a.ps * a.D * sizeof(P);
  const size_t scr =
      (size_t)kWarps * GB * (a.lpr * VEC + 2 + 1) * sizeof(float);
  // no more stages than the split has pages (plus the one consumed), all
  // within a block's share
  int ns = a.pps + 1 < kMaxStages ? a.pps + 1 : kMaxStages;
  while (ns > 1 && head + (stage * ns > scr ? stage * ns : scr) > kMaxSmem)
    --ns;
  const size_t smem = head + (stage * ns > scr ? stage * ns : scr);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  a.n_stages = ns;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_split_kernel<T, P, VEC, GB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.n_split, a.KV * a.n_gb * a.n_ds, B);
  paged_split_kernel<T, P, VEC, GB><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename P, int VEC>
cudaError_t launch_split_rows(SplitArgs a, int B, cudaStream_t stream) {
  // query rows a block: at most kMaxRows, as even as the row blocks go,
  // rounded up to an instance: 6 (qwen2-1.5b's group) or 8; the rows past
  // the group's are masked
  a.n_gb = (a.G + kMaxRows - 1) / kMaxRows;
  const int rows = (a.G + a.n_gb - 1) / a.n_gb;
  a.n_chunk = (a.D + VEC - 1) / VEC;
  a.lpr = next_pow2(a.n_chunk) < 32 ? next_pow2(a.n_chunk) : 32;
  a.n_ds = (a.n_chunk + a.lpr - 1) / a.lpr;
  return rows <= 6 ? launch_split<T, P, VEC, 6>(a, B, stream)
                   : launch_split<T, P, VEC, 8>(a, B, stream);
}

template <typename T, typename P, int VEC>
cudaError_t launch_merge(const MergeArgs& a, int B, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * a.D * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_merge_kernel<T, P, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // launched as a programmatic dependent of the split pass
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.G, a.KV, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, paged_merge_kernel<T, P, VEC>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t launch(SplitArgs sa, MergeArgs ma, int B, cudaStream_t stream) {
  const bool D4 = sa.D % 4 == 0;  // 16-byte rows of the fp32 partials
  // columns a lane: 16 bytes of fp32 or bf16, 8 bytes of e4m3
  constexpr int kVec = sizeof(P) == 4 ? 4 : 8;
  const bool vec = (sa.D * sizeof(P)) % 16 == 0 &&
                   (sa.D * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sa.q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sa.k_pool) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sa.v_pool) % 16 == 0;
  cudaError_t err = vec ? launch_split_rows<T, P, kVec>(sa, B, stream)
                        : launch_split_rows<T, P, 1>(sa, B, stream);
  if (err != cudaSuccess) return err;
  return D4 ? launch_merge<T, P, 4>(ma, B, stream)
            : launch_merge<T, P, 1>(ma, B, stream);
}

}  // namespace

extern "C" {

// One call, two launches (split pass, merge pass) on `stream`.
//   q (B, KV, G, D), pools (P, KV, ps, D); q's dtype 0 = float32,
//   1 = bfloat16; pool_dtype q's, or 2 = float8 e4m3 (kt too);
//   q is scaled by `scale` and rounded to its dtype on load.
//   kv_len (B,) int32.  window <= 0: none.  pps: pages a split.
//   acc_p, m_p, l_p: scratch for the partials, (B, KV, ceil(n_pages/pps),
//   G, D) and (B, KV, ceil(n_pages/pps), G) fp32.
//   kt non-null: merge the self term (kt in the pools' dtype, vt fp32,
//   bf16 or e4m3 by vt_dtype 0/1/2) and write out (B, 1, KV*G, D) in q's
//   dtype; else write acc
//   (B, KV, G, D), m, l (B, KV, G) fp32.
// Returns the cudaError_t of the launches (0 on success).
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* pages,
                           const void* kv_len, void* acc_p, void* m_p,
                           void* l_p,
                           const void* kt, const void* vt, int vt_dtype,
                           void* out, void* acc, void* m, void* l, int B,
                           int KV, int G, int D, int ps, int n_pages,
                           int window, int pps, float scale, int dtype,
                           int pool_dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || KV <= 0 || G <= 0 || D <= 0 || ps <= 0 || n_pages <= 0 ||
      pps <= 0 || B > 65535 || (kt != nullptr && (vt_dtype < 0 ||
                                                   vt_dtype > 2)))
    return (int)cudaErrorInvalidValue;
  SplitArgs sa{};
  sa.q = q;
  sa.k_pool = k_pool;
  sa.v_pool = v_pool;
  sa.pages = static_cast<const int32_t*>(pages);
  sa.kv_len = static_cast<const int32_t*>(kv_len);
  sa.acc_p = static_cast<float*>(acc_p);
  sa.m_p = static_cast<float*>(m_p);
  sa.l_p = static_cast<float*>(l_p);
  sa.KV = KV;
  sa.G = G;
  sa.D = D;
  sa.ps = ps;
  sa.n_pages = n_pages;
  sa.window = window;
  sa.pps = pps < n_pages ? pps : n_pages;
  sa.n_split = (n_pages + sa.pps - 1) / sa.pps;
  sa.scale = scale;
  MergeArgs ma{};
  ma.acc_p = sa.acc_p;
  ma.m_p = sa.m_p;
  ma.l_p = sa.l_p;
  ma.KV = KV;
  ma.G = G;
  ma.D = D;
  ma.n_split = sa.n_split;
  ma.q = q;
  ma.kt = kt;
  ma.vt = vt;
  ma.vt_dtype = vt_dtype;
  ma.scale = scale;
  ma.out = out;
  ma.acc = static_cast<float*>(acc);
  ma.m = static_cast<float*>(m);
  ma.l = static_cast<float*>(l);
  if (dtype == 0 && pool_dtype == 0)
    return (int)launch<float, float>(sa, ma, B, st);
  if (dtype == 1 && pool_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(sa, ma, B, st);
  if (dtype == 0 && pool_dtype == 2)
    return (int)launch<float, e4m3>(sa, ma, B, st);
  if (dtype == 1 && pool_dtype == 2)
    return (int)launch<__nv_bfloat16, e4m3>(sa, ma, B, st);
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
