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
// Every operand is read through the strides the caller gives (x, y and B, C
// with unit stride along their last axis), so the model's (B·nc, Q, H, P)
// memory is read and written in place, with no relayout copy around the
// kernel.  The inter-chunk recurrence stays in PyTorch (models/ssm.py
// ssd_chunked).
//
// Bound.  At the serving shape (BC 1, H 32, Q 256, P 64, N 128) the
// function moves about 5.6 MB (1.7 µs at 3.35 TB/s) and needs about 0.28
// GFLOP counting C Bᵀ once per chunk and only the causal half (4.2 µs at
// 67 TFLOP/s fp32): it is bound by operations.  The TPU kernel holds a
// head's whole (Q, Q) matrix in VMEM on a (BC, H) grid; on Hopper the
// matrix (256 KB at Q 256) overruns a block's 227 KB and 32 blocks cannot
// fill 132 SMs.  The first port formed C Bᵀ again in every head's blocks
// (about 640 MFLOP issued, 335 of them the repeated C Bᵀ), walked the
// causal triangle unevenly (the last row tile's block did four times the
// first one's rounds) and staged single-buffered.  This design answers
// each of those:
//
// * Pass 1, C Bᵀ once per chunk.  Grid (tiles, BC), 256 threads: a block
//   forms one 32 x 32 tile of C Bᵀ over all of N (one round of 16-byte
//   loads of C and B rows, then 2 x 2 outputs a thread) and writes it,
//   transposed ([s][t]), into a scratch (BC, Qp, Qp) the wrapper allocates
//   (Qp: Q rounded up to the main pass's row tile; 256 KB a chunk at Q
//   256, so it stays in L2).  Only the tiles the main pass reads are formed:
//   those below or on the diagonal at the main pass's tile size (36 at Q
//   256 with 32-row tiles, 40 with 64).  The pass triggers its dependent
//   at once (`griddepcontrol.launch_dependents`).
// * Pass 2, launched as a programmatic dependent of pass 1.  Grid (y and
//   S blocks, H, BC), 4R threads for R rows a tile (R = 32 or 64, the
//   launch shape), each block owning an R x 64 output tile.  Every block
//   stages a and dt (4-byte `cp.async`, a group of their own) and forms cum
//   (one warp: each lane sums a segment, a shuffle scan offsets the
//   segments) while its first x rows are in flight; only the y blocks then
//   wait for pass 1 (`griddepcontrol.wait`), since the S blocks never read
//   C Bᵀ.
//   - A y block owns the pair of row tiles t and n_t − 1 − t of one head
//     and 64 columns p, so every y block walks n_t + 1 column tiles (5 at
//     R 64, 9 at R 32, Q 256): the causal walk is balanced.  For each
//     column tile it stages C Bᵀ's [s][t] tile from the scratch and x's
//     rows, turns the tile into M in place, where s <= t, by
//     M = C Bᵀ · exp(cum_t − cum_s) · dt_s (a select, so the exp above the
//     diagonal, which may overflow, is never used; the exponential is the
//     special-function unit's `ex2.approx` of the difference times log2 e,
//     about 2^-22 relative), and accumulates M (dt ⊙ x).  A thread reads
//     all its elements of the tile before it writes any, so the reads go
//     out together (one pointer reaches the tile, cum and dt, and the
//     compiler keeps a read after an earlier write).
//   - An S block owns R rows n and 64 columns p of S and reduces over the
//     chunk in steps of R positions: it stages B's and x's rows, weights
//     B's rows in place by dt_s · exp(cum_end − cum_s) and accumulates.
//     At Q 256 an S block takes 8 (R 32) or 4 (R 64) steps of R
//     positions, as long as a y block's walk.
//   The product splits each step's R positions over four K-slices of R
//   threads; a thread holds an 8 x 8 register tile (rows 4rg.. and R/2 +
//   4rg.., columns 4pg.. and 32 + 4pg..), four 16-byte shared-memory loads
//   for 64 FMAs a position (a 4 x 4 tile takes two loads for 16, and every
//   16-byte load costs a shared-memory wavefront per quarter warp).  At
//   the end of a row tile the slices' partial sums meet in shared memory
//   (rows padded to 65 floats) and are added in a fixed order.  Both kinds
//   of block stage through a ring of three (A tile, x tile) stages by
//   `cp.async`, 16-byte copies where every row is 16-byte aligned and
//   4-byte copies on ragged shapes (zero-filled past Q, P and N), two steps
//   in flight while the third is consumed, two barriers a step.  Each
//   output element is written by exactly one block in a fixed order: no
//   atomics, and the result is the same bit for bit on every call.
//
// Arithmetic is fp32 FMA on the CUDA cores: no TF32 (about three digits,
// too coarse for the 1e-4 tolerance).  The cumsum's order differs from
// torch.cumsum's, so kernel and plain version disagree by a few ulp of
// |cum| (stated in chip_smoke.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssd_scan.so ssd_scan.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPTile = 64;     // columns p of an output tile
constexpr int kStages = 3;     // ring stages: steps in flight + 1
constexpr int kCbTile = 32;    // rows and columns of a pass-1 tile
constexpr int kCbDepth = 128;  // depth (of N) of one pass-1 round
constexpr int kCbStride = kCbDepth + 4;  // padded: float4 rows spread banks
constexpr int kCbThreads = 256;
constexpr size_t kMaxSmem = 232448;  // a block's share of an SM on Hopper
constexpr float kLog2e = 1.4426950408889634f;

struct CbArgs {
  const float* Bm;
  const float* Cm;
  float* cb;               // (BC, Qp, Qp): C Bᵀ transposed, [s][t]
  int64_t bs_bc, bs_q;     // B's strides (unit stride along n)
  int64_t cs_bc, cs_q;     // C's
  int Q, N, Qp, R;         // R: the main pass's rows a tile
};

struct MainArgs {
  const float* x;
  const float* dt;
  const float* a;
  const float* Bm;
  const float* cb;
  float* y;
  float* S;
  int64_t xs_bc, xs_h, xs_q;        // x (unit stride along p)
  int64_t ds_bc, ds_h, ds_q;        // dt
  int64_t as_bc, as_h, as_q;        // a
  int64_t bs_bc, bs_q;              // B (unit stride along n)
  int64_t ys_bc, ys_h, ys_q;        // y (unit stride along p)
  int64_t ss_bc, ss_h, ss_n, ss_p;  // S
  int Q, P, N, Qp, n_t, n_pt, n_y;  // n_y: y blocks of one (bc, h)
};

// asynchronous copies global -> shared; a source size of 0 fills zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Programmatic dependent launch (Hopper): pass 2 is launched while pass 1
// runs; its y blocks wait for pass 1's grid to finish and its writes to
// show before they read C Bᵀ.
__device__ __forceinline__ void grid_dep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// 2^x by the special-function unit (relative error about 2^-22; 0 below
// 2^-126)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Stage a ROWS x COLS tile whose element (r, c) is g[r * ld + c] into
// dst[r * LDS + c]: VEC floats a copy, rows >= rows_ok and columns >=
// cols_ok zero-filled (with VEC 4, cols_ok is a multiple of 4).  `base` is
// any valid address, the source of the zero fills.
template <int VEC, int ROWS, int COLS, int LDS, int NT>
__device__ __forceinline__ void stage_tile(float* dst, const float* g,
                                           int64_t ld, int rows_ok,
                                           int cols_ok, const float* base) {
  constexpr int kPerRow = COLS / VEC;
  static_assert(ROWS * kPerRow % NT == 0, "staging loops have no tail");
#pragma unroll
  for (int it = 0; it < ROWS * kPerRow / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * VEC;
    const bool ok = r < rows_ok && c < cols_ok;
    const float* src = ok ? g + r * ld + c : base;
    if constexpr (VEC == 4)
      cp_async16(dst + r * LDS + c, src, ok);
    else
      cp_async4(dst + r * LDS + c, src, ok);
  }
}

// Pass-1 tiles (32 x 32) of row tile ti: every column tile si whose
// main-pass tile (R rows) lies on or below ti's.
__host__ __device__ inline int cb_tiles_of_row(int ti, int R) {
  const int per = R / kCbTile;
  return (ti / per + 1) * per;
}

__host__ __device__ inline int cb_tile_count(int Qp, int R) {
  int n = 0;
  for (int ti = 0; ti < Qp / kCbTile; ++ti) n += cb_tiles_of_row(ti, R);
  return n;
}

// ---- pass 1: C Bᵀ ---------------------------------------------------------

template <int VEC>
__global__ void __launch_bounds__(kCbThreads) ssd_cb_kernel(CbArgs p) {
  grid_dep_launch_dependents();
  __shared__ __align__(16) float c_s[kCbTile * kCbStride];
  __shared__ __align__(16) float b_s[kCbTile * kCbStride];
  int rem = blockIdx.x, ti = 0;
  while (rem >= cb_tiles_of_row(ti, p.R)) rem -= cb_tiles_of_row(ti++, p.R);
  const int t0 = ti * kCbTile;
  const int s0 = rem * kCbTile;
  const int bc = blockIdx.y;
  const float* Cg = p.Cm + bc * p.cs_bc + t0 * p.cs_q;
  const float* Bg = p.Bm + bc * p.bs_bc + s0 * p.bs_q;
  const int tl = threadIdx.x & 15;  // rows t tl, tl + 16
  const int sl = threadIdx.x >> 4;  // columns s sl, sl + 16
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int k0 = 0; k0 < p.N; k0 += kCbDepth) {
    stage_tile<VEC, kCbTile, kCbDepth, kCbStride, kCbThreads>(
        c_s, Cg + k0, p.cs_q, p.Q - t0, p.N - k0, p.Cm);
    stage_tile<VEC, kCbTile, kCbDepth, kCbStride, kCbThreads>(
        b_s, Bg + k0, p.bs_q, p.Q - s0, p.N - k0, p.Bm);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kCbDepth; k += 4) {
      float4 c[2], b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        c[i] = *reinterpret_cast<const float4*>(c_s + (tl + 16 * i) *
                                                kCbStride + k);
        b[i] = *reinterpret_cast<const float4*>(b_s + (sl + 16 * i) *
                                                kCbStride + k);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          acc[i][j] = fmaf(c[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(c[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(c[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(c[i].w, b[j].w, acc[i][j]);
        }
    }
    __syncthreads();  // the round's reads are done before the next staging
  }
  float* out = p.cb + (size_t)bc * p.Qp * p.Qp;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      out[(size_t)(s0 + sl + 16 * j) * p.Qp + t0 + tl + 16 * i] = acc[i][j];
}

// ---- pass 2: y and S -----------------------------------------------------

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

template <int R>
__host__ __device__ constexpr int stage_floats() {
  return R * R + R * kPTile;  // the A tile ([s][t] or [s][n]), x's rows
}

// the K-slices' partial sums of an R x 64 output tile, rows padded to 65
// floats so that both the writes and the column-major reads spread banks
template <int R>
__host__ __device__ constexpr int reduce_floats() {
  return 4 * R * (kPTile + 1);
}

template <int R, int VEC>
__global__ void __launch_bounds__(4 * R) ssd_main_kernel(MainArgs p) {
  constexpr int NT = 4 * R;
  constexpr int kStage = stage_floats<R>();
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned
  float* ring = reinterpret_cast<float*>(smem4);
  float* red = ring + kStages * kStage;  // the K-slices' partial sums
  float* cum = red + reduce_floats<R>();  // Qp: cum, zeros past Q
  float* wt = cum + p.Qp;                 // Qp: dt (y) or S's weights
  const int tid = threadIdx.x;
  // the product's thread roles: K-slice ks takes R / 4 of a step's R
  // positions; in it a thread owns rows 4rg + i and R/2 + 4rg + i and
  // columns 4pg + j and 32 + 4pg + j (i, j < 4) of the block's R x 64 tile
  const int ks = tid / R;
  const int rg = (tid % R) >> 3;
  const int pg = tid & 7;
  const int h = blockIdx.y;
  const int bc = blockIdx.z;
  const bool is_y = (int)blockIdx.x < p.n_y;
  const int idx = is_y ? blockIdx.x : blockIdx.x - p.n_y;
  const int tile = idx / p.n_pt;  // y: the pair; S: the row tile of n
  const int p0 = (idx - tile * p.n_pt) * kPTile;
  // y: row tiles ta, then tb (ta == tb: one); S: the chunk's n_t steps
  const int ta = tile;
  const int tb = p.n_t - 1 - tile;
  const int n_steps = is_y ? ta + 1 + (tb != ta ? tb + 1 : 0) : p.n_t;
  const int n0 = tile * R;

  const float* xg = p.x + bc * p.xs_bc + h * p.xs_h + p0;
  const float* Bg = p.Bm + bc * p.bs_bc + n0;
  const float* cbg = p.cb + (size_t)bc * p.Qp * p.Qp;
  // step k: positions s0 = its column tile; y: rows of row tile t_row
  auto col_tile = [&](int k) { return !is_y || k <= ta ? k : k - ta - 1; };
  auto row_tile = [&](int k) { return k <= ta ? ta : tb; };
  auto stage_x = [&](int k) {
    const int s0 = col_tile(k) * R;
    stage_tile<VEC, R, kPTile, kPTile, NT>(ring + (k % kStages) * kStage +
                                               R * R,
                                           xg + s0 * p.xs_q, p.xs_q,
                                           p.Q - s0, p.P - p0, p.x);
  };
  auto stage_a = [&](int k) {
    const int s0 = col_tile(k) * R;
    float* A = ring + (k % kStages) * kStage;
    if (is_y)  // the scratch: padded to Qp, aligned, every tile formed
      stage_tile<4, R, R, R, NT>(A, cbg + (size_t)s0 * p.Qp +
                                        row_tile(k) * R,
                                 p.Qp, R, R, p.cb);
    else
      stage_tile<VEC, R, R, R, NT>(A, Bg + s0 * p.bs_q, p.bs_q, p.Q - s0,
                                   p.N - n0, p.Bm);
  };

  // what depends on no other pass goes first: a and dt (a group of their
  // own), then x's first rows and S's B rows, left in flight
  const float* dg = p.dt + bc * p.ds_bc + h * p.ds_h;
  const float* ag = p.a + bc * p.as_bc + h * p.as_h;
  for (int i = tid; i < p.Qp; i += NT) {
    const bool in = i < p.Q;
    cp_async4(cum + i, in ? ag + i * p.as_q : p.a, in);
    cp_async4(wt + i, in ? dg + i * p.ds_q : p.dt, in);
  }
  cp_async_commit();
  stage_x(0);
  if (!is_y) stage_a(0);
  cp_async_wait<0>();  // a and dt (the later copies are in no group yet)
  __syncthreads();
  if (tid < 32) warp_cumsum(cum, p.Q);
  __syncthreads();
  if (!is_y) {
    const float cum_end = cum[p.Q - 1];
    for (int i = tid; i < p.Q; i += NT) wt[i] *= expf(cum_end - cum[i]);
  }
  if (is_y) {
    grid_dep_wait();  // pass 1's C Bᵀ is written and visible
    stage_a(0);
  }
  cp_async_commit();
  if (n_steps > 1) {
    stage_x(1);
    stage_a(1);
  }
  cp_async_commit();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // the K-slices' partial sums into `red`, acc zeroed for the next tile
  auto publish = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* row = red + (ks * R + (i >> 2) * (R / 2) + 4 * rg + (i & 3)) *
                             (kPTile + 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        row[(j >> 2) * 32 + 4 * pg + (j & 3)] = acc[i][j];
        acc[i][j] = 0.f;
      }
    }
    __syncthreads();
  };
  // element (r, c) of the tile: the four slices summed in a fixed order
  auto total = [&](int r, int c) {
    constexpr int kSlice = R * (kPTile + 1);
    const float* e = red + r * (kPTile + 1) + c;
    return ((e[0] + e[kSlice]) + e[2 * kSlice]) + e[3 * kSlice];
  };

  for (int k = 0; k < n_steps; ++k) {
    cp_async_wait<1>();
    __syncthreads();  // step k landed (and, at k 0, cum and wt are set);
                      // every thread is done with step k - 1's stage
    if (k + 2 < n_steps) {
      stage_x(k + 2);
      stage_a(k + 2);
    }
    cp_async_commit();
    float* A = ring + (k % kStages) * kStage;
    const float* X = A + R * R;
    const int s0 = col_tile(k) * R;
    const int t0 = row_tile(k) * R;
    // the A tile in place: y's M = C Bᵀ · exp(cum_t − cum_s) · dt_s where
    // s <= t < Q, else 0 (a select); S's weighted B rows.  A thread's
    // elements share a column (t) and step R / 4 rows apart; all of them
    // are read before any is written, so the reads go out together.
    {
      constexpr int kPer = R / 4;
      const int c = tid % R;
      const int tg = t0 + c;
      float v[kPer];
#pragma unroll
      for (int it = 0; it < kPer; ++it) v[it] = A[c + (tid / R + 4 * it) * R];
      if (is_y) {
        const float cum_t = cum[tg];
#pragma unroll
        for (int it = 0; it < kPer; ++it) {
          const int sg = s0 + tid / R + 4 * it;
          const float m =
              v[it] * fast_exp2((cum_t - cum[sg]) * kLog2e) * wt[sg];
          v[it] = (sg <= tg && tg < p.Q) ? m : 0.f;
        }
      } else {
#pragma unroll
        for (int it = 0; it < kPer; ++it) v[it] *= wt[s0 + tid / R + 4 * it];
      }
#pragma unroll
      for (int it = 0; it < kPer; ++it) A[c + (tid / R + 4 * it) * R] = v[it];
    }
    __syncthreads();
    // this K-slice's R / 4 positions (rows past Q hold zeros in both
    // tiles): four 16-byte loads for 64 FMAs a position
    const float* As = A + ks * (R / 4) * R;
    const float* Xs = X + ks * (R / 4) * kPTile;
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + q * R + 4 * rg);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + q * R + R / 2 + 4 * rg);
      const float4 x0 =
          *reinterpret_cast<const float4*>(Xs + q * kPTile + 4 * pg);
      const float4 x1 =
          *reinterpret_cast<const float4*>(Xs + q * kPTile + 32 + 4 * pg);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
    }
    if (is_y && (k == ta || k == n_steps - 1)) {
      // the row tile is done: sum the slices, store its rows, and start
      // the next one
      publish();
      float* yg = p.y + bc * p.ys_bc + h * p.ys_h;
      for (int o = tid; o < R * kPTile; o += NT) {
        const int r = o / kPTile;
        const int c = o % kPTile;
        if (t0 + r < p.Q && p0 + c < p.P)
          yg[(t0 + r) * p.ys_q + p0 + c] = total(r, c);
      }
      __syncthreads();  // `red` is read before the next tile writes it
    }
  }
  cp_async_wait<0>();  // the empty trailing groups: none left in flight
  if (!is_y) {
    publish();
    float* Sg = p.S + bc * p.ss_bc + h * p.ss_h;
    for (int o = tid; o < R * kPTile; o += NT) {
      const int r = o % R;  // consecutive threads, consecutive n
      const int c = o / R;
      if (n0 + r < p.N && p0 + c < p.P)
        Sg[(n0 + r) * p.ss_n + (p0 + c) * p.ss_p] = total(r, c);
    }
  }
}

template <typename K, typename Args>
cudaError_t launch_ex(K kernel, dim3 grid, int threads, size_t smem,
                      cudaStream_t stream, bool dependent, const Args& args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = dependent ? attr : nullptr;
  cfg.numAttrs = dependent ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int R, int VEC>
cudaError_t launch_main(const MainArgs& a, int H, int BC,
                        cudaStream_t stream) {
  const size_t smem = ((size_t)kStages * stage_floats<R>() +
                       reduce_floats<R>() + 2 * (size_t)a.Qp) *
                      sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_main_kernel<R, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int n_s = (a.N + R - 1) / R * a.n_pt;
  return launch_ex(ssd_main_kernel<R, VEC>, dim3(a.n_y + n_s, H, BC), 4 * R,
                   smem, stream, true, a);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// One call, two launches on `stream`: pass 1 (C Bᵀ into the scratch cb,
// (BC, Qp, Qp) fp32 with Qp = Q rounded up to row_tile) and pass 2 (y, S)
// as its programmatic dependent.  All pointers are fp32 device arrays;
// strides (in elements) are, in order: x (bc, h, q), dt (bc, h, q), a (bc,
// h, q), B (bc, q), C (bc, q), y (bc, h, q), S (bc, h, n, p); x, B, C and y
// have unit stride along their last axis.  row_tile: 32 or 64.  Returns
// the cudaError_t of the launches (0 on success).
int ssd_intra_chunk_launch(const void* x, const void* dt, const void* a,
                           const void* Bm, const void* Cm, void* cb, void* y,
                           void* S, const int64_t* strides, int BC, int H,
                           int Q, int P, int N, int row_tile, void* stream) {
  if (BC <= 0 || H <= 0 || Q <= 0 || P <= 0 || N <= 0 || BC > 65535 ||
      H > 65535 || (row_tile != 32 && row_tile != 64))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* s = strides;
  const int R = row_tile;
  const int Qp = (Q + R - 1) / R * R;
  // 16-byte copies where every row of x, B and C, and of y, is aligned
  const int row_strides[] = {0, 1, 2, 9, 10, 11, 12, 13, 14, 15};
  bool vec = P % 4 == 0 && N % 4 == 0 && aligned16(x) && aligned16(Bm) &&
             aligned16(Cm) && aligned16(y);
  for (int i : row_strides) vec = vec && s[i] % 4 == 0;

  CbArgs ca{};
  ca.Bm = static_cast<const float*>(Bm);
  ca.Cm = static_cast<const float*>(Cm);
  ca.cb = static_cast<float*>(cb);
  ca.bs_bc = s[9];
  ca.bs_q = s[10];
  ca.cs_bc = s[11];
  ca.cs_q = s[12];
  ca.Q = Q;
  ca.N = N;
  ca.Qp = Qp;
  ca.R = R;
  const dim3 cb_grid(cb_tile_count(Qp, R), BC);
  cudaError_t err =
      vec ? launch_ex(ssd_cb_kernel<4>, cb_grid, kCbThreads, 0, st, false, ca)
          : launch_ex(ssd_cb_kernel<1>, cb_grid, kCbThreads, 0, st, false,
                      ca);
  if (err != cudaSuccess) return (int)err;

  MainArgs ma{};
  ma.x = static_cast<const float*>(x);
  ma.dt = static_cast<const float*>(dt);
  ma.a = static_cast<const float*>(a);
  ma.Bm = ca.Bm;
  ma.cb = ca.cb;
  ma.y = static_cast<float*>(y);
  ma.S = static_cast<float*>(S);
  ma.xs_bc = s[0];
  ma.xs_h = s[1];
  ma.xs_q = s[2];
  ma.ds_bc = s[3];
  ma.ds_h = s[4];
  ma.ds_q = s[5];
  ma.as_bc = s[6];
  ma.as_h = s[7];
  ma.as_q = s[8];
  ma.bs_bc = s[9];
  ma.bs_q = s[10];
  ma.ys_bc = s[13];
  ma.ys_h = s[14];
  ma.ys_q = s[15];
  ma.ss_bc = s[16];
  ma.ss_h = s[17];
  ma.ss_n = s[18];
  ma.ss_p = s[19];
  ma.Q = Q;
  ma.P = P;
  ma.N = N;
  ma.Qp = Qp;
  ma.n_t = Qp / R;
  ma.n_pt = (P + kPTile - 1) / kPTile;
  ma.n_y = (ma.n_t + 1) / 2 * ma.n_pt;
  if (R == 32)
    err = vec ? launch_main<32, 4>(ma, H, BC, st)
              : launch_main<32, 1>(ma, H, BC, st);
  else
    err = vec ? launch_main<64, 4>(ma, H, BC, st)
              : launch_main<64, 1>(ma, H, BC, st);
  return (int)err;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
