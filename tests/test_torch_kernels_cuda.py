"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

These tests need an NVIDIA GPU (sm_90a, nvcc): each is marked ``cuda`` and
skips without a CUDA device.  The file imports neither JAX nor the JAX
package, so it runs on the machine with the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

The input builder and the paged-attention cases (the JAX package's, and
the split plan's edge cases) are shared with the CPU parity tests
(``test_torch_paged_attention.py``); the paged kernel runs at every
pages-a-split value of the tuner's grid.  The SSD inputs follow
the JAX package's kernel test, with strongly negative decays added; the
Jacobi inputs follow ``apps/jacobi.py``'s ``make_system`` at ragged N,
N 1 and the paper's largest N; the RMSNorm cases are ``chip_smoke.py``'s,
with odd widths and an unaligned start added for the scalar path.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.jacobi_sweep import (jacobi_sweep_plain,
                                              jacobi_sweep_residual_plain)
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.kernels.ssd_scan import ssd_intra_chunk_plain
from repro_torch.kernels.tuning import DEFAULT_CANDIDATES

# B, H, KV, D, page_size, n_slot_pages, kv_lens, window, share, trash —
# the JAX package's cases (ragged, windowed, COW-shared, mid-prefill
# trash), plus a window of one (only the self term is visible)
PA_CASES = [
    (3, 4, 2, 64, 8, 4, (5, 17, 0), None, False, 0),
    (2, 8, 8, 64, 16, 3, (31, 16), None, False, 0),
    (4, 4, 4, 32, 8, 6, (40, 23, 8, 1), 11, False, 0),
    (3, 2, 2, 64, 16, 4, (33, 33, 50), None, True, 0),
    (2, 4, 2, 32, 8, 5, (37, 21), None, False, 1),
    (2, 4, 1, 64, 16, 2, (9, 25), 7, True, 0),
    (3, 4, 2, 32, 8, 4, (9, 16, 30), 1, False, 0),
]

# the split plan's edge cases, in the same layout
SPLIT_CASES = [
    (2, 4, 2, 32, 8, 7, (0, 0), None, False, 0),        # every split empty
    (2, 4, 2, 32, 8, 5, (1, 8), None, False, 0),        # kv_len 1; a page end
    (3, 4, 2, 32, 8, 7, (56, 24, 16), None, False, 0),  # 7 pages: no pps fits
    (3, 4, 2, 32, 8, 7, (9, 16, 0), 1, False, 0),       # window 1, a free slot
    # G 5; D 40: bf16 rows of 80 bytes take the scalar staging path
    (2, 10, 2, 40, 4, 5, (19, 3), None, False, 1),
    # G 16: two blocks of query rows; fp32 D 256: two column slices
    (2, 32, 2, 256, 8, 3, (17, 9), 5, False, 0),
    # D 42: not a multiple of 4, so the merge pass reads scalars too
    (2, 6, 2, 42, 8, 4, (29, 8), 5, False, 0),
]

# card only: fp32 pages of 64 x 256, where two stages of K and V overrun
# a block's shared memory, so the split pass stages one page at a time
# (a trash tail too).  Not a CPU case: its raw 64-term page sums differ
# from the Pallas kernel's by more than the CPU tests' 2e-6 in any order,
# the unsplit plain version's too.
STAGING_CASES = [
    (2, 4, 2, 256, 64, 3, (150, 64), None, False, 1),
]

# card only: multi-head attention (G 1) at the served MoE and hybrid
# widths — qwen2-moe-a2.7b (H = KV 16, D 128) and zamba2-1.2b's shared
# block (H = KV 32, D 64) — at the serving batch and page size, ragged
# lengths and a free slot
MHA_CASES = [
    (8, 16, 16, 128, 16, 16, (256, 200, 129, 64, 17, 1, 0, 100), None,
     False, 0),
    (8, 32, 32, 64, 16, 16, (256, 200, 129, 64, 17, 1, 0, 100), None,
     False, 0),
]

# card only: gemma3-4b's decode (bf16 serving; KV 4, G 2, D 256) at the
# serving batch and page size, contexts of 1,000-1,500 tokens and a free
# slot, without a window (global layers) and under the local layers'
# window of 1,024
GEMMA3_CASES = [
    (8, 8, 4, 256, 16, 96, (1500, 1400, 1300, 1200, 1100, 1024, 1000, 0),
     window, False, 0)
    for window in (None, 1024)
]


def paged_case(seed, B, H, KV, D, page_size, n_slot_pages, kv_lens, *,
               share=False, trash_tail=0):
    """numpy inputs in the serve layouts; page 0 is NaN-poisoned."""
    rng = np.random.default_rng(seed)
    n_pool = 1 + B * n_slot_pages
    k_pool = rng.standard_normal((n_pool, KV, page_size, D), np.float32)
    v_pool = rng.standard_normal((n_pool, KV, page_size, D), np.float32)
    k_pool[0] = np.nan
    v_pool[0] = np.nan
    table = np.zeros((B, n_slot_pages), np.int32)
    nxt = 1
    for b, L in enumerate(kv_lens):
        need = -(-max(int(L), 1) // page_size)
        for i in range(need):
            if share and b > 0 and i == 0:
                table[b, i] = table[0, 0]
            else:
                table[b, i] = nxt
                nxt += 1
        for i in range(max(need - trash_tail, 0), need):
            table[b, i] = 0
    q = rng.standard_normal((B, 1, H, D), np.float32)
    kt = rng.standard_normal((B, KV, 1, D), np.float32)
    vt = rng.standard_normal((B, KV, 1, D), np.float32)
    return q, k_pool, v_pool, table, np.asarray(kv_lens, np.int32), kt, vt



def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _kernel_vs_plain(case, dtype, pps, seed=15):
    """The kernel's (acc, m, l) against its plain version's on ``case``
    at ``pps`` pages a split (None: the kernel's default)."""
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    B, H, KV, D, ps, n, lens, window, share, trash = case
    q, kp, vp, tbl, kv_len, _, _ = paged_case(
        seed, B, H, KV, D, ps, n, lens, share=share, trash_tail=trash)
    dt = getattr(torch, dtype)
    G = H // KV
    qg = torch.from_numpy(q.reshape(B, KV, G, D) / np.sqrt(D)).to(dt)
    args = [qg] + [t.to(dt) for t in _torch(kp, vp)] + _torch(tbl, kv_len)
    args = [a.cuda() for a in args]
    acc, m, l = paged_attention_kernel(*args, window=window,
                                       pages_per_split=pps)
    acc_p, m_p, l_p = paged_attention_plain(*args, window=window)
    torch.testing.assert_close(m, m_p, atol=1e-5, rtol=1e-5)
    # acc / l: the attention output before the self term (a slot with no
    # visible position has acc == l == 0 on both sides)
    torch.testing.assert_close(acc / l.clamp_min(1e-30)[..., None],
                               acc_p / l_p.clamp_min(1e-30)[..., None],
                               atol=1e-5, rtol=1e-5)


PPS_GRID = [c["pages_per_split"]
            for c in DEFAULT_CANDIDATES["paged_attention"]]


@pytest.mark.cuda
@pytest.mark.parametrize("pps", PPS_GRID)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PA_CASES + SPLIT_CASES + STAGING_CASES
                         + MHA_CASES + GEMMA3_CASES,
                         ids=[f"paged{i}" for i in
                              range(len(PA_CASES + SPLIT_CASES
                                        + STAGING_CASES + MHA_CASES
                                        + GEMMA3_CASES))])
def test_cuda_kernel_matches_plain(case, dtype, pps):
    """The hand-written kernel against its plain version, on the card, at
    every pages-a-split value of the tuner's grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _kernel_vs_plain(case, dtype, pps)


@pytest.mark.cuda
@pytest.mark.parametrize("case", GEMMA3_CASES, ids=["global", "local"])
def test_cuda_paged_kernel_at_gemma3_is_bit_identical_on_repeat(case):
    """gemma3's decode shape in bf16 at the default split: two calls on
    one input give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    B, H, KV, D, ps, n, lens, window, share, trash = case
    q, kp, vp, tbl, kv_len, _, _ = paged_case(17, B, H, KV, D, ps, n, lens)
    qg = torch.from_numpy(q.reshape(B, KV, H // KV, D) / np.sqrt(D))
    args = [t.to(torch.bfloat16).cuda() for t in [qg] + _torch(kp, vp)]
    args += [t.cuda() for t in _torch(tbl, kv_len)]
    first = paged_attention_kernel(*args, window=window)
    again = paged_attention_kernel(*args, window=window)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("pps", PPS_GRID + [None])
def test_cuda_paged_kernel_long_context(pps):
    """The serving shape: qwen2-1.5b's heads (G 6, D 128) over 128 pages
    of 16 at batch 8, ragged lengths up to 2048 and a free slot, fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    case = (8, 12, 2, 128, 16, 128, (2048, 1999, 1500, 1024, 777, 300, 17,
                                     0), None, False, 0)
    _kernel_vs_plain(case, "float32", pps)


# card only: qwen2-1.5b's decode on a TP=2 position of the serving mesh
# (its 12 query and 2 KV heads split in two: KV 1, G 6, D 128) at the
# serving batch and page size, contexts of 1,000-1,500 tokens and a free
# slot
TP_SHARD_CASE = (8, 6, 1, 128, 16, 96,
                 (1500, 1431, 1362, 1293, 1224, 1155, 1000, 0), None, False,
                 0)


@pytest.mark.cuda
@pytest.mark.parametrize("pps", PPS_GRID + [None])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_kernel_at_a_tp_shard(dtype, pps):
    """The kernel at the TP=2 shard's shape (KV 1: half the blocks of the
    unsplit decode) against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _kernel_vs_plain(TP_SHARD_CASE, dtype, pps)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_wrapper_launches_kernel_and_matches_ref(dtype):
    """The whole wrapper (kernel + self-term merge) against its gather
    oracle; one launch counted per call, none for the oracle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.paged_attention import (kernel,
                                                     paged_decode_attention)
    dt = getattr(torch, dtype)
    arrays = paged_case(16, 3, 12, 2, 128, 16, 5, (70, 33, 0))
    q, kp, vp, tbl, kv_len, kt, vt = [a.cuda() for a in _torch(*arrays)]
    q, kp, vp, kt, vt = (t.to(dt) for t in (q, kp, vp, kt, vt))
    before = kernel.launches
    out = paged_decode_attention(q, kp, vp, tbl, kv_len, kt, vt)
    assert kernel.launches == before + 1
    ref = paged_decode_attention(q, kp, vp, tbl, kv_len, kt, vt, impl="ref")
    assert kernel.launches == before + 1
    assert torch.isfinite(out).all()
    tol = 1e-5 if dt == torch.float32 else 1e-2     # one bf16 rounding
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("pps", [1, 16])
def test_cuda_paged_wrapper_takes_every_length_form(pps):
    """kv_len as an int, a one-element tensor, an int64 (B,) tensor and
    the int32 (B,) the decode path holds give one answer, fp32 kt/vt."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.paged_attention import paged_decode_attention
    arrays = paged_case(20, 3, 8, 2, 64, 8, 6, (41, 41, 41))
    q, kp, vp, tbl, kv_len, kt, vt = [a.cuda() for a in _torch(*arrays)]
    ref = paged_decode_attention(q, kp, vp, tbl, kv_len, kt, vt, impl="ref")
    for kl in (41, torch.tensor([41], device="cuda"), kv_len.long(), kv_len):
        out = paged_decode_attention(q, kp, vp, tbl, kl, kt, vt,
                                     pages_per_split=pps)
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


# BC, H, Q, P, N: the serving shape at the largest and smallest chunk
# buckets, several chunks at once, the kernel bench's shape, the CPU
# tests' Q = 8, and ragged shapes that leave every tile edge partial (P 70
# and N 130 also take the 4-byte staging path)
SSD_CASES = [
    (1, 32, 256, 64, 128),
    (1, 32, 16, 64, 128),
    (8, 4, 256, 64, 128),
    (8, 8, 128, 64, 64),
    (2, 2, 8, 16, 16),
    (3, 3, 100, 70, 130),
    (2, 1, 1, 8, 8),
    # zamba2-1.2b (H 64, P 64, N 64): a paged prefill chunk, and the dense
    # engine's batched prefill of 8 prompts of 1,024 tokens (32 chunks)
    (1, 64, 256, 64, 64),
    (32, 64, 256, 64, 64),
    # a TP=2 head shard of mamba2-370m's training mesh: 16 of its 32 heads
    # over micro-batch 2 at seq 4096 (forward here, gradients below)
    (32, 16, 256, 64, 128),
]
SSD_ROW_TILES = [c["row_tile"] for c in DEFAULT_CANDIDATES["ssd_scan"]]
SSD_TOL = 1e-4        # max|Δ| / max|plain|, y and S: the cumsum's order


def ssd_case(seed, BC, H, Q, P, N, *, strong=False):
    """fp32 inputs; ``strong`` draws a uniform in [-3, 0) per step, so the
    decays over a chunk span hundreds of e-folds."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BC, H, Q, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((BC, H, Q, 1)))).astype(
        np.float32)
    if strong:
        a = -rng.uniform(0.0, 3.0, (BC, H, Q, 1)).astype(np.float32)
    else:
        a = (-np.exp(rng.standard_normal((BC, H, Q, 1)) * 0.3) * dt).astype(
            np.float32)
    B = rng.standard_normal((BC, Q, N)).astype(np.float32)
    C = rng.standard_normal((BC, Q, N)).astype(np.float32)
    return x, dt, a, B, C


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("row_tile", SSD_ROW_TILES)
@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("case", SSD_CASES)
def test_cuda_ssd_kernel_matches_plain(case, strong, row_tile):
    """The hand-written SSD kernel against its plain version, on the card,
    at every launch shape of the tuner's grid; one launch counted per
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.ssd_scan import kernel, ssd_intra_chunk
    args = [t.cuda() for t in _torch(*ssd_case(17, *case, strong=strong))]
    before = kernel.launches
    y, S = ssd_intra_chunk(*args, row_tile=row_tile)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    y_p, S_p = ssd_intra_chunk_plain(*args)
    assert y.shape == y_p.shape and S.shape == S_p.shape
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    assert _rel(y, y_p) <= SSD_TOL and _rel(S, S_p) <= SSD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("row_tile", SSD_ROW_TILES)
def test_cuda_ssd_kernel_is_bit_identical_on_repeat(row_tile):
    """Every output element is written by one block in a fixed order:
    two calls on the same inputs agree to the bit (and with the default
    launch shape's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.ssd_scan import ssd_intra_chunk
    for case in ((1, 32, 256, 64, 128), (3, 3, 100, 70, 130)):
        args = [t.cuda() for t in _torch(*ssd_case(19, *case, strong=True))]
        y1, S1 = ssd_intra_chunk(*args, row_tile=row_tile)
        y2, S2 = ssd_intra_chunk(*args, row_tile=row_tile)
        torch.cuda.synchronize()
        assert torch.equal(y1, y2) and torch.equal(S1, S2)


@pytest.mark.cuda
def test_cuda_ssd_kernel_reads_the_model_layout():
    """The model's (B·nc, Q, H, P) memory goes in as strided views, with no
    copy, and y, S come back as views of (BC, Q, H, P) and (BC, H, P, N)
    memory, equal to the plain version on contiguous copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.ssd_scan import ssd_intra_chunk
    rng = np.random.default_rng(20)
    BC, Q, H, P, N = 3, 256, 8, 64, 128
    xm, dm, Bm, Cm = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).cuda() for s in ((BC, Q, H, P), (BC, Q, H), (BC, Q, N),
                                      (BC, Q, N)))
    dm = torch.nn.functional.softplus(dm)
    args = (xm.transpose(1, 2), dm.transpose(1, 2)[..., None],
            (-dm).transpose(1, 2)[..., None], Bm, Cm)
    for row_tile in SSD_ROW_TILES:
        y, S = ssd_intra_chunk(*args, row_tile=row_tile)
        assert y.transpose(1, 2).is_contiguous()
        assert S.transpose(2, 3).is_contiguous()
        y_p, S_p = ssd_intra_chunk_plain(*(t.contiguous() for t in args))
        assert _rel(y, y_p) <= SSD_TOL and _rel(S, S_p) <= SSD_TOL


@pytest.mark.cuda
def test_cuda_ssd_wrapper_refuses_a_launch_shape_outside_the_grid(
        monkeypatch):
    """A row tile outside the grid is refused before any build or launch,
    by the wrapper and by the binding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import kernel, ssd_intra_chunk

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(kernel, "_lib", None)
    args = [t.cuda() for t in _torch(*ssd_case(21, 1, 2, 16, 64, 128))]
    before = kernel.launches
    for bad in (16, 48, 128):
        with pytest.raises(ValueError, match="launch shapes"):
            ssd_intra_chunk(*args, row_tile=bad)
        with pytest.raises(ValueError, match="launch shapes"):
            kernel.ssd_intra_chunk_kernel(*args, row_tile=bad)
    assert kernel.launches == before


@pytest.mark.cuda
def test_cuda_ssd_chunked_kernel_path_matches_plain_path():
    """The model's chunked scan through the kernel (with its relayout)
    against the einsum path: several chunks, a padded tail, an initial
    state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.models.ssm import ssd_chunked
    rng = np.random.default_rng(18)
    B, S, H, P, N = 2, 600, 8, 64, 128
    x, dt, Bm, Cm = _torch(
        rng.standard_normal((B, S, H, P)).astype(np.float32),
        np.log1p(np.exp(rng.standard_normal((B, S, H)) - 3)).astype(
            np.float32),
        rng.standard_normal((B, S, N)).astype(np.float32),
        rng.standard_normal((B, S, N)).astype(np.float32))
    A = -torch.linspace(1.0, 16.0, H)
    s0 = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(
        np.float32))
    args = [t.cuda() for t in (x, dt, A, Bm, Cm)]
    yk, fk = ssd_chunked(*args, chunk=256, initial_state=s0.cuda(),
                         impl="kernel")
    yr, fr = ssd_chunked(*args, chunk=256, initial_state=s0.cuda(),
                         impl="ref")
    assert _rel(yk, yr) <= SSD_TOL and _rel(fk, fr) <= SSD_TOL


# SsdIntraChunkFn's cases: SSD_CASES and mamba2-370m's training shape
# (micro-batch 2 at seq 4096: 32 chunks of 256); zamba2-1.2b's, (32, 64,
# 256, 64, 64), is in SSD_CASES already
SSD_GRAD_CASES = SSD_CASES + [(32, 32, 256, 64, 128)]
SSD_GRAD_TOL = 1e-4   # max|Δ| / max|plain| of each input's gradient


@pytest.mark.cuda
@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("case", SSD_GRAD_CASES)
def test_cuda_ssd_intra_chunk_fn_gradients_match_autograd(case, strong):
    """The kernel path under grad (``SsdIntraChunkFn``: the kernel's
    forward, the plain version's derivative as backward) against autograd
    through the plain version, fp32: every input's gradient within 1e-4
    of max|plain| and finite under the strong decays; one kernel call,
    none in the backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.ssd_scan import kernel, ssd_intra_chunk
    args = [t.cuda().requires_grad_()
            for t in _torch(*ssd_case(25, *case, strong=strong))]
    before = kernel.launches
    y, S = ssd_intra_chunk(*args)
    gen = torch.Generator("cuda").manual_seed(26)
    dy = torch.randn(y.shape, device="cuda", generator=gen)
    dS = torch.randn(S.shape, device="cuda", generator=gen)
    got = torch.autograd.grad((y, S), args, (dy, dS))
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    y_p, S_p = ssd_intra_chunk_plain(*args)
    want = torch.autograd.grad((y_p, S_p), args, (dy, dS))
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert _rel(g, w) <= SSD_GRAD_TOL


@pytest.mark.cuda
def test_cuda_ssd_kernel_refuses_inputs_that_need_a_gradient():
    """Called directly under grad, the binding refuses: it has no
    gradient of its own, and a dropped one would go unnoticed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.ssd_scan import kernel
    args = [t.cuda() for t in _torch(*ssd_case(27, 1, 2, 16, 64, 128))]
    args[0].requires_grad_()
    before = kernel.launches
    with pytest.raises(RuntimeError, match="SsdIntraChunkFn"):
        kernel.ssd_intra_chunk_kernel(*args)
    with torch.no_grad():
        kernel.ssd_intra_chunk_kernel(*args)
    assert kernel.launches == before + 1


# N, A dtype, x dtype: ragged N (every row of an odd N starts off a 16-byte
# boundary), N 1, the bf16 cases of the JAX kernel tests, and the paper's
# largest size
JACOBI_CASES = [
    (200, "float32", "float32"),
    (333, "float32", "float32"),
    (1, "float32", "float32"),
    (31, "float32", "float32"),
    (300, "float32", "bfloat16"),
    (300, "bfloat16", "float32"),
    (257, "bfloat16", "bfloat16"),
    (7209, "float32", "float32"),
]


def jacobi_case(seed, n, a_dtype, x_dtype):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((n, n)) / n).astype(np.float32)
    np.fill_diagonal(A, 3.0)
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    A, x, b = (t.cuda() for t in _torch(A, x, b))
    A = A.to(getattr(torch, a_dtype))
    return A, x.to(getattr(torch, x_dtype)), b, torch.diagonal(A).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", JACOBI_CASES)
def test_cuda_jacobi_kernels_match_plain(case):
    """Both Jacobi kernels against their plain versions, on the card: x' in
    x's dtype within 1e-5 of max|plain| (fp32 x; one bf16 rounding with
    bf16 x), and the fused kernel's Σr² within 1e-5; one launch counted per
    kernel call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.jacobi_sweep import (jacobi_sweep,
                                                  jacobi_sweep_residual,
                                                  kernel)
    torch.backends.cuda.matmul.allow_tf32 = False
    n, a_dtype, x_dtype = case
    A, x, b, d = jacobi_case(19, n, a_dtype, x_dtype)
    tol = 1e-5 if x_dtype == "float32" else 2.0 ** -7
    before = dict(kernel.launches)
    x1 = jacobi_sweep(A, x, b, d)
    x2, res = jacobi_sweep_residual(A, x, b, d)
    torch.cuda.synchronize()
    assert kernel.launches == {k: v + 1 for k, v in before.items()}
    p1 = jacobi_sweep_plain(A, x, b, d)
    p2, rsq = jacobi_sweep_residual_plain(A, x, b, d)
    for got, want in ((x1, p1), (x2, p2)):
        assert got.dtype == x.dtype and got.shape == (n,)
        assert torch.isfinite(got.float()).all()
        assert _rel(got.float(), want.float()) <= tol
    assert abs(float(res) ** 2 - float(rsq)) <= 1e-5 * float(rsq)


@pytest.mark.cuda
def test_cuda_jacobi_tailored_runs_the_kernel():
    """``jacobi_tailored(kernel=True)`` on the card launches the fused
    kernel once per iteration plus one warm-up, and agrees with the plain
    loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.apps.jacobi import jacobi_tailored, make_system
    from repro_torch.kernels.jacobi_sweep import kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    A, b, _ = make_system(1001)
    before = kernel.launches["jacobi_sweep_residual"]
    rk = jacobi_tailored(A, b, iters=40, kernel=True)
    assert kernel.launches["jacobi_sweep_residual"] == before + 41
    rp = jacobi_tailored(A, b, iters=40)
    assert rk.iters == rp.iters == 40
    np.testing.assert_allclose(rk.x, rp.x, atol=1e-5, rtol=1e-5)


# B, S, T, H, KV, D, causal, window: the JAX package's FA_CASES, ragged S
# and T (every tile edge partial), the smoke configs' head width 24, S > T
# with rows that see no key at all, and the training shape's head layout
FA_CASES = [
    (1, 128, 128, 4, 4, 64, True, None),
    (2, 256, 256, 4, 2, 64, True, None),
    (1, 512, 512, 8, 2, 32, True, 64),
    (2, 256, 256, 8, 8, 32, False, None),
    (1, 384, 384, 4, 1, 64, True, 100),
    (1, 256, 256, 2, 2, 128, True, None),
    (2, 77, 77, 4, 2, 24, True, None),
    (1, 200, 131, 12, 2, 128, False, 50),
    (1, 100, 40, 2, 2, 32, True, 16),
    (2, 1000, 1000, 12, 2, 128, True, None),
]
FA_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # the reference's own
FA_LSE_TOL = 1e-4


def fa_case(seed, B, S, T, H, KV, D, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D)))
    return [t.cuda().to(getattr(torch, dtype)) for t in (q, k, v)]


# card only: the dense engine's batched prefill of 8 prompts of 1,024
# tokens with multi-head attention (H = KV), qwen2-moe-a2.7b's D 128 and
# zamba2-1.2b's shared block's D 64
FA_SERVE_CASES = [
    (8, 1024, 1024, 16, 16, 128, True, None),
    (8, 1024, 1024, 32, 32, 64, True, None),
]

# head dim 256 (gemma3-4b): causal and under its local window of 1,024
# over two windows' worth of rows; a window of 16 on ragged S > T (the last
# row sees no key); non-causal under a window; and, card only, gemma3's
# batched prefill of 8 prompts of 2,048 tokens, global and local
FA_WIDE_CASES = [
    (2, 1100, 1100, 8, 4, 256, True, None),
    (2, 1100, 1100, 8, 4, 256, True, 1024),
    (1, 77, 61, 4, 2, 256, True, 16),
    (1, 200, 131, 4, 4, 256, False, 50),
]
FA_GEMMA3_CASES = [(8, 2048, 2048, 8, 4, 256, True, w) for w in (None, 1024)]

# whisper-base (H = KV 8, D 64, non-causal, 1,500 encoder frames): the
# encoder's self-attention, and the decoder's cross-attention of a 64-token
# prompt and of one decode token over the frames
FA_WHISPER_CASES = [
    (8, 1500, 1500, 8, 8, 64, False, None),
    (8, 64, 1500, 8, 8, 64, False, None),
    (8, 1, 1500, 8, 8, 64, False, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES + FA_SERVE_CASES + FA_WIDE_CASES
                         + FA_GEMMA3_CASES + FA_WHISPER_CASES)
def test_cuda_flash_kernel_matches_plain(case, dtype):
    """The hand-written flash kernel against its plain version, on the
    card: output at the reference's tolerance, LSE at 1e-4, rows with no
    visible key zero and finite; one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain,
                                                     kernel)
    B, S, T, H, KV, D, causal, window = case
    q, k, v = fa_case(20, B, S, T, H, KV, D, dtype)
    before = kernel.launches["flash_attention"]
    out, lse = flash_attention_kernel(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kernel.launches["flash_attention"] == before + 1
    out_p, lse_p = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert lse.shape == (B, H, S) and torch.isfinite(out.float()).all()
    tol = FA_TOL[dtype]
    torch.testing.assert_close(out.float(), out_p.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, lse_p, atol=FA_LSE_TOL, rtol=FA_LSE_TOL)


FA_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # of max|plain|
FA_BLOCKS = [(q, kv) for q in (64, 128) for kv in (64, 128)]


# gemma3-4b's training shapes at micro-batch 2 (global and local layers)
FA_GEMMA3_TRAIN_CASES = [(2, 4096, 4096, 8, 4, 256, True, w)
                         for w in (None, 1024)]

# the backward's cases: FA_CASES, the training shape, head dims below 64
# (TMA zero-fills columns D..63) with S and T off every tile edge, causal
# and under a window, and D 256 (FA_WIDE_CASES: rows that see no key, S
# and T off the tile edges, non-causal; gemma3's training shapes)
FA_BWD_CASES = FA_CASES + FA_WIDE_CASES + FA_GEMMA3_TRAIN_CASES + [
    (2, 4096, 4096, 12, 2, 128, True, None),
    (2, 200, 200, 6, 2, 24, True, None),
    (1, 150, 93, 6, 3, 24, True, 40),
    (2, 200, 200, 6, 2, 40, True, None),
    (1, 150, 93, 6, 3, 40, True, 40),
    # whisper-base's training shapes at micro-batch 2: cross-attention of
    # 448 decoder tokens over 1,500 frames, and the encoder's 1,500 frames
    (2, 448, 1500, 8, 8, 64, False, None),
    (2, 1500, 1500, 8, 8, 64, False, None),
]


def _fa_bwd_inputs(case, dtype, seed=24):
    B, S, T, H, KV, D, causal, window = case
    q, k, v = fa_case(seed, B, S, T, H, KV, D, dtype)
    rng = np.random.default_rng(seed + 1)
    dout = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)).cuda().to(q.dtype)
    return q, k, v, dout


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", FA_BLOCKS)
@pytest.mark.parametrize("case", FA_CASES)
def test_cuda_flash_kernel_every_launch_shape(case, blocks):
    """The bf16 forward at every (q_block, kv_block) of the tuner's grid
    against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain)
    B, S, T, H, KV, D, causal, window = case
    q, k, v = fa_case(25, B, S, T, H, KV, D, "bfloat16")
    qb, kb = blocks
    out, lse = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                      q_block=qb, kv_block=kb)
    out_p, lse_p = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
    torch.testing.assert_close(out.float(), out_p.float(),
                               atol=FA_TOL["bfloat16"],
                               rtol=FA_TOL["bfloat16"])
    torch.testing.assert_close(lse, lse_p, atol=FA_LSE_TOL, rtol=FA_LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", FA_BLOCKS)
@pytest.mark.parametrize("case", FA_WIDE_CASES + FA_GEMMA3_CASES)
def test_cuda_flash_kernel_head_dim_256_every_launch_shape(case, blocks):
    """The bf16 forward at D 256 at every (q_block, kv_block) of the
    tuner's grid: 64-key tiles match the plain version and give the same
    bits on a repeat call; 128-key tiles are refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain,
                                                     kernel)
    B, S, T, H, KV, D, causal, window = case
    q, k, v = fa_case(27, B, S, T, H, KV, D, "bfloat16")
    qb, kb = blocks
    before = kernel.launches["flash_attention"]
    if kb == 128:
        with pytest.raises(ValueError, match="kv_block 128"):
            flash_attention_kernel(q, k, v, causal=causal, window=window,
                                   q_block=qb, kv_block=kb)
        assert kernel.launches["flash_attention"] == before
        return
    out, lse = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                      q_block=qb, kv_block=kb)
    again, lse_again = flash_attention_kernel(q, k, v, causal=causal,
                                              window=window, q_block=qb,
                                              kv_block=kb)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    out_p, lse_p = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
    torch.testing.assert_close(out.float(), out_p.float(),
                               atol=FA_TOL["bfloat16"],
                               rtol=FA_TOL["bfloat16"])
    torch.testing.assert_close(lse, lse_p, atol=FA_LSE_TOL, rtol=FA_LSE_TOL)
    if window is not None and S > T + window - 1:
        assert (out[:, T + window - 1:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_WIDE_CASES + FA_WHISPER_CASES)
def test_cuda_flash_kernel_is_bit_identical_on_repeat(case, dtype):
    """Two calls of the forward on one input, at D 256 and at whisper's
    non-causal shapes with S != T, give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    B, S, T, H, KV, D, causal, window = case
    q, k, v = fa_case(28, B, S, T, H, KV, D, dtype)
    first = flash_attention_kernel(q, k, v, causal=causal, window=window)
    again = flash_attention_kernel(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_BWD_CASES)
def test_cuda_flash_backward_kernel_matches_plain(case, dtype):
    """The backward kernel against the plain backward on the forward's
    output and LSE: dq, dk, dv within 1e-4 (fp32) / 2e-2 (bf16) of
    max|plain|, in the inputs' dtype, bit-identical on a repeat call, dq
    zero on rows that see no key; one call counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_kernel, flash_attention_backward_plain,
        flash_attention_kernel, kernel)
    B, S, T, H, KV, D, causal, window = case
    q, k, v, dout = _fa_bwd_inputs(case, dtype)
    out, lse = flash_attention_kernel(q, k, v, causal=causal, window=window)
    before = kernel.launches["flash_attention_bwd"]
    got = flash_attention_backward_kernel(q, k, v, out, lse, dout,
                                          causal=causal, window=window)
    again = flash_attention_backward_kernel(q, k, v, out, lse, dout,
                                            causal=causal, window=window)
    torch.cuda.synchronize()
    assert kernel.launches["flash_attention_bwd"] == before + 2
    want = flash_attention_backward_plain(q, k, v, out, lse, dout,
                                          causal=causal, window=window)
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        assert _rel(g, w) <= FA_BWD_TOL[dtype]
        assert torch.equal(g, a)
    if window is not None and S > T + window - 1:
        assert (got[0][:, T + window - 1:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_backward_kernel_reads_strided_inputs(dtype, D):
    """q, k and v as views of one fused projection, dO a transposed view:
    the backward kernel matches the plain backward on contiguous copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_kernel, flash_attention_backward_plain,
        flash_attention_kernel)
    B, S, H, KV = 2, 300, 4, 2
    rng = np.random.default_rng(26)
    qkv = torch.from_numpy(rng.standard_normal(
        (B, S, H + 2 * KV, D)).astype(np.float32)).cuda().to(
            getattr(torch, dtype))
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    dout = torch.from_numpy(rng.standard_normal((B, H, S, D)).astype(
        np.float32)).cuda().to(q.dtype).transpose(1, 2)
    out, lse = flash_attention_kernel(q, k, v, causal=True, window=70)
    got = flash_attention_backward_kernel(q, k, v, out, lse, dout,
                                          causal=True, window=70)
    want = flash_attention_backward_plain(
        *(t.contiguous() for t in (q, k, v, out)), lse, dout.contiguous(),
        causal=True, window=70)
    for g, w in zip(got, want):
        assert _rel(g, w) <= FA_BWD_TOL[dtype]


@pytest.mark.cuda
def test_cuda_flash_kernel_reads_strided_inputs():
    """q, k and v as views of one fused projection (not contiguous): the
    kernel reads them through their strides and matches the plain
    version on contiguous copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain)
    B, S, H, KV, D = 2, 300, 4, 2, 64
    rng = np.random.default_rng(21)
    qkv = torch.from_numpy(rng.standard_normal(
        (B, S, H + 2 * KV, D)).astype(np.float32)).cuda()
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    out, lse = flash_attention_kernel(q, k, v, causal=True)
    out_p, lse_p = flash_attention_plain(*(t.contiguous() for t in (q, k, v)),
                                         causal=True)
    torch.testing.assert_close(out, out_p, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, lse_p, atol=FA_LSE_TOL, rtol=FA_LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 33])
def test_cuda_flash_fn_gradients_match_autograd_through_plain(window):
    """``FlashAttentionFn`` with the kernel forward: its output and its
    gradients against torch autograd through the plain version, fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import (
        FlashAttentionFn, flash_attention_backward_plain,
        flash_attention_plain, kernel)
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, KV, D = 2, 333, 6, 2, 64
    q, k, v = (t.requires_grad_() for t in fa_case(22, B, S, S, H, KV, D,
                                                   "float32"))
    dout = torch.randn((B, S, H, D), device="cuda")
    before = dict(kernel.launches)
    out, lse = FlashAttentionFn.apply(q, k, v, True, window, "kernel")
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert kernel.launches == {
        "flash_attention": before["flash_attention"] + 1,
        "flash_attention_bwd": before["flash_attention_bwd"] + 1}
    out_p, _ = flash_attention_plain(q, k, v, causal=True, window=window)
    grads_p = torch.autograd.grad(out_p, (q, k, v), dout)
    torch.testing.assert_close(out, out_p, atol=1e-5, rtol=1e-5)
    for g, gp in zip(grads, grads_p):
        torch.testing.assert_close(g, gp, atol=1e-4, rtol=1e-4)
    # the plain backward, tiled small, on the same output and LSE
    small = flash_attention_backward_plain(
        *(t.detach() for t in (q, k, v, out)), lse, dout, causal=True,
        window=window, q_tile=64)
    for g, gs in zip(grads, small):
        torch.testing.assert_close(g, gs, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_flash_wrapper_refuses_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    q, k, v = fa_case(23, 1, 16, 16, 2, 2, 32, "float32")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_kernel(*fa_case(23, 1, 16, 16, 2, 2, 264,
                                         "float32"))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_kernel(*fa_case(23, 1, 16, 16, 2, 2, 20, "float32"))
    with pytest.raises(TypeError, match="not supported"):
        flash_attention_kernel(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="differs"):
        flash_attention_kernel(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_kernel(q, k.cpu(), v)
    with pytest.raises(ValueError, match="contiguous last"):
        flash_attention_kernel(q.transpose(1, 3).contiguous().transpose(1, 3),
                               k, v)


@pytest.mark.cuda
def test_cuda_train_step_runs_the_kernel_and_matches_the_plain_path():
    """One fused step of the qwen2 smoke config in bf16 on the card: every
    attention layer launches the flash forward twice a micro-batch (the
    remat recompute) and the backward kernel once, and the loss and grad
    norm match the tiled path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, SyntheticLMStream, to_device
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.optim import OptimizerSpec, global_norm
    from repro_torch.train import TrainState, compute_grads, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("qwen2-1.5b")
    spec = OptimizerSpec(lr=1e-3)
    batch = to_device(SyntheticLMStream(cfg, DataConfig(
        global_batch=4, seq_len=200)).batch(0), "cuda")
    state = TrainState.create(cfg, spec,
                              torch.Generator("cuda").manual_seed(0), "cuda")
    grads, loss_p, _ = compute_grads(cfg, state.params, batch, accum=2,
                                     impl="tiled")
    before = dict(kernel.launches)
    state, m = make_train_step(cfg, spec, grad_accum=2)(state, batch)
    assert kernel.launches == {
        "flash_attention": before["flash_attention"] + 2 * cfg.n_layers * 2,
        "flash_attention_bwd": (before["flash_attention_bwd"]
                                + 2 * cfg.n_layers)}
    assert abs(float(m["loss_total"]) / float(loss_p) - 1) < 1e-3
    assert abs(float(m["grad_norm"]) / float(global_norm(grads)) - 1) < 2e-2


# arch: the SSD layers (mamba2, zamba2), the MoE blocks, whisper's encoder
# and cross-attention (non-causal flash, S != T)
TRAIN_FAMILIES = ["qwen2-moe-a2.7b", "mamba2-370m", "zamba2-1.2b",
                  "whisper-base"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_cuda_train_step_of_each_family_runs_its_kernels(arch):
    """One fused step (2 micro-batches) of each family's smoke config in
    fp32 on the card: the flash forward twice and the backward once an
    attention layer and a micro-batch, the SSD kernel twice an SSM layer
    and a micro-batch (the remat recompute; its backward is plain); loss
    and grad norm as on the plain path (``impl="ref"``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.data import DataConfig, SyntheticLMStream, to_device
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.models.transformer import layer_kinds, layer_plan
    from repro_torch.optim import OptimizerSpec, global_norm
    from repro_torch.train import TrainState, compute_grads, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, _ = _smoke_model(arch, "float32")
    spec = OptimizerSpec(lr=1e-3)
    batch = to_device(SyntheticLMStream(cfg, DataConfig(
        global_batch=4, seq_len=100)).batch(0), "cuda")
    state = TrainState.create(cfg, spec,
                              torch.Generator("cuda").manual_seed(0), "cuda")
    grads, loss_p, _ = compute_grads(cfg, state.params, batch, accum=2,
                                     impl="ref")
    kinds = layer_kinds(cfg)
    n_ssm = kinds.count("ssm")
    n_attn = len(kinds) - n_ssm + (layer_plan(cfg).enc_groups
                                   + kinds.count("dec"))
    before = (dict(fa_kernel.launches), ssd_kernel.launches)
    state, m = make_train_step(cfg, spec, grad_accum=2)(state, batch)
    torch.cuda.synchronize()
    assert fa_kernel.launches == {
        "flash_attention": before[0]["flash_attention"] + 2 * n_attn * 2,
        "flash_attention_bwd": before[0]["flash_attention_bwd"] + 2 * n_attn}
    assert ssd_kernel.launches == before[1] + 2 * n_ssm * 2
    assert abs(float(m["loss_total"]) / float(loss_p) - 1) < 1e-4
    assert abs(float(m["grad_norm"]) / float(global_norm(grads)) - 1) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "zamba2-1.2b"])
def test_cuda_save_dots_matches_full_through_the_kernels(arch):
    """``remat="save_dots"`` on the card, with the flash and SSD kernels
    recomputed and the 2-D products kept: the gradients of ``full``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import dataclasses

    from repro_torch.data import DataConfig, SyntheticLMStream, to_device
    from repro_torch.models.transformer import loss_fn
    from repro_torch.tree import tree_leaves, tree_unflatten
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _smoke_model(arch, "float32")
    batch = to_device(SyntheticLMStream(cfg, DataConfig(
        global_batch=2, seq_len=100)).batch(0), "cuda")
    out = []
    for remat in ("full", "save_dots"):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        total, _ = loss_fn(dataclasses.replace(cfg, remat=remat),
                           tree_unflatten(params, leaves), batch)
        out.append(torch.autograd.grad(total, leaves))
    for a, b in zip(*out):
        assert _rel(b, a) <= 1e-6


# R, d, dtype: chip_smoke.py's cases (the kernel bench's shape, qwen2-1.5b's
# width at one training micro-batch, ragged rows, the widest d, a d that
# leaves the vector loop ragged), plus odd widths that defeat 16-byte
# vectors and a single row
RMS_CASES = [
    (4096, 1024, "float32"),
    (8192, 1536, "bfloat16"),
    (1000, 1536, "bfloat16"),
    (64, 16384, "bfloat16"),
    (7, 200, "float32"),
    (5, 203, "float32"),
    (3, 99, "bfloat16"),
    (1, 64, "float32"),
]
RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # of max|plain|
RMS_ROW_BLOCKS = (1, 2, 4, 8, 32)


def rms_case(seed, R, d, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((R, d)).astype(np.float32))
    g = torch.from_numpy((rng.standard_normal(d) + 1.0).astype(np.float32))
    return x.cuda().to(getattr(torch, dtype)), g.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("case", RMS_CASES)
def test_cuda_rmsnorm_kernel_matches_plain(case):
    """The hand-written RMSNorm kernel against its plain version under
    every rows-a-block value: fp32 within 1e-5 and bf16 within 2e-2 of
    max|plain| (the card sums the squares in another order; one bf16
    spacing); one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.rmsnorm import kernel, rmsnorm_kernel, \
        rmsnorm_plain
    R, d, dtype = case
    x, g = rms_case(24, R, d, dtype)
    want = rmsnorm_plain(x, g, eps=1e-6)
    for rb in RMS_ROW_BLOCKS:
        before = kernel.launches
        got = rmsnorm_kernel(x, g, eps=1e-6, row_block=rb)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert got.dtype == x.dtype and got.shape == x.shape
        assert torch.isfinite(got.float()).all()
        assert _rel(got.float(), want.float()) <= RMS_TOL[dtype], rb


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_kernel_reads_an_unaligned_start(dtype):
    """A contiguous input whose first element lies off a 16-byte boundary
    takes the scalar path and gives the same rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.rmsnorm import rmsnorm_kernel, rmsnorm_plain
    x, g = rms_case(25, 37, 256, dtype)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    xu = buf[1:].view(37, 256)
    xu.copy_(x)
    assert xu.is_contiguous() and xu.data_ptr() % 16
    got = rmsnorm_kernel(xu, g, eps=1e-5, row_block=4)
    assert _rel(got.float(), rmsnorm_plain(x, g, eps=1e-5).float()) <= \
        RMS_TOL[dtype]


@pytest.mark.cuda
def test_cuda_rmsnorm_wrapper_and_norm_switch_launch_the_kernel(tmp_path,
                                                               monkeypatch):
    """``rmsnorm(impl="auto")`` and ``apply_norm(use_kernel=True)`` on
    CUDA tensors launch the kernel (never the plain version), with the
    tuned rows a block when the cache has one, for any leading shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import tuning
    from repro_torch.kernels.rmsnorm import kernel, ops, rmsnorm, \
        rmsnorm_plain
    from repro_torch.models.layers import apply_norm
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    tuning.get_tuner().cache.put(
        tuning.cache_key("rmsnorm", "cuda", (30, 96), torch.float32),
        {"config": {"row_block": 2}, "median_s": 1e-5})
    used = []
    real = ops.rmsnorm_kernel

    def spy(*a, **kw):
        used.append(kw["row_block"])
        return real(*a, **kw)

    monkeypatch.setattr(ops, "rmsnorm_kernel", spy)
    monkeypatch.setattr(ops, "rmsnorm_plain", None)   # must not be called
    x, g = rms_case(26, 30, 96, "float32")
    x3 = x.reshape(2, 15, 96)
    before = kernel.launches
    out = rmsnorm(x3, g)
    assert kernel.launches == before + 1 and used == [2]
    assert out.shape == x3.shape
    assert _rel(out.reshape(30, 96), rmsnorm_plain(x, g)) <= 1e-5
    cfg = get_smoke_config("qwen2-1.5b")
    p = {"scale": torch.ones(cfg.d_model, device="cuda",
                             dtype=torch.bfloat16)}
    h = torch.randn(2, 9, cfg.d_model, device="cuda").bfloat16()
    got = apply_norm(cfg, p, h, use_kernel=True)
    assert kernel.launches == before + 2
    assert _rel(got.float(), apply_norm(cfg, p, h).float()) <= 2e-2


@pytest.mark.cuda
def test_cuda_rmsnorm_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.rmsnorm import kernel, rmsnorm_kernel
    x, g = rms_case(27, 8, 64, "float32")
    before = kernel.launches
    with pytest.raises(RuntimeError, match="forward only"):
        rmsnorm_kernel(x.clone().requires_grad_(), g, eps=1e-6, row_block=4)
    with pytest.raises(RuntimeError, match="forward only"):
        rmsnorm_kernel(x, g.clone().requires_grad_(), eps=1e-6, row_block=4)
    with pytest.raises(TypeError, match="not supported"):
        rmsnorm_kernel(x.half(), g, eps=1e-6, row_block=4)
    with pytest.raises(TypeError, match="gain must be float32"):
        rmsnorm_kernel(x, g.bfloat16(), eps=1e-6, row_block=4)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_kernel(x.t(), g[:8].contiguous(), eps=1e-6, row_block=4)
    with pytest.raises(ValueError, match="row_block"):
        rmsnorm_kernel(x, g, eps=1e-6, row_block=33)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rmsnorm_kernel(x, g.cpu(), eps=1e-6, row_block=4)
    assert kernel.launches == before
    with torch.no_grad():                  # no graph: nothing to refuse
        rmsnorm_kernel(x.clone().requires_grad_(), g, eps=1e-6, row_block=4)
    assert kernel.launches == before + 1


@pytest.mark.cuda
def test_cuda_tuner_round_trip(tmp_path):
    """The autotuner on the card, in a fresh cache: the RMSNorm kernel's
    candidates timed by CUDA events (a positive per-call time well under a
    millisecond), then the same bucket a hit that times nothing; the
    wrapper's lookup returns the winner."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels import tuning
    from repro_torch.kernels.rmsnorm import kernel, rmsnorm
    tuner = tuning.Autotuner(tuning.TuningCache(str(tmp_path / "t.json")))
    x, g = rms_case(28, 4096, 1024, "float32")

    def make_call(cfg):
        return lambda: rmsnorm(x, g, **cfg)

    before = kernel.launches
    e = tuner.tune("rmsnorm", make_call, shape=x.shape, dtype=x.dtype,
                   backend="cuda", flops=3.0 * x.numel(),
                   bytes_moved=8.0 * x.numel())
    assert e["timed"] == len(tuning.DEFAULT_CANDIDATES["rmsnorm"])
    assert e["impl"] == "kernel" and e["backend"] == "cuda"
    assert 0 < e["median_s"] < 1e-3
    assert kernel.launches > before
    launched = kernel.launches
    again = tuner.tune("rmsnorm", make_call, shape=(4000, 1000),
                       dtype=x.dtype, backend="cuda")
    assert again == e and kernel.launches == launched
    assert tuner.lookup("rmsnorm", x.shape, x.dtype,
                        backend="cuda") == e["config"]
    params = tuning.calibrated_cost_params(tuner=tuner, backend="cuda")
    assert params.mem_bw == pytest.approx(8.0 * x.numel() / e["median_s"])


# the dense engine's batched prefill: B, S (ragged S included), tolerance
# of the last-token logits against the plain path, of max|logit|
DENSE_PREFILL_CASES = [(2, 64), (3, 77), (1, 300), (2, 1)]
DENSE_PREFILL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _smoke_model(arch, dtype):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.weights import init_params
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
    return cfg, init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            "cuda")


def _prefill_paths(cfg, params, B, S, impls, counter):
    """Last-token logits of a batched prefill from a fresh dense cache
    through each ``impl``, and the kernel calls each made."""
    from repro_torch.models.transformer import decode_step, init_cache
    toks = torch.randint(0, cfg.vocab_size - 1, (B, S), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    out = {}
    for impl in impls:
        cache = init_cache(cfg, B, S + 8, device="cuda")
        before = counter()
        lg, cache = decode_step(cfg, params, cache, toks, impl=impl,
                                valid_len=S)
        torch.cuda.synchronize()
        assert int(cache["len"]) == S
        out[impl] = (lg[:, -1].float(), counter() - before)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DENSE_PREFILL_CASES)
def test_cuda_dense_prefill_flash_route_matches_dense(case, dtype):
    """The dense engine's batched prefill on the card: ``auto`` runs the
    flash kernel once a layer (S > 1; S == 1 decodes, plainly) and its
    logits match the plain ``dense`` core's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S = case
    cfg, params = _smoke_model("qwen2-1.5b", dtype)
    out = _prefill_paths(cfg, params, B, S, ("dense", "auto"),
                         lambda: kernel.launches["flash_attention"])
    (want, n_plain), (got, n_kernel) = out["dense"], out["auto"]
    assert n_plain == 0
    assert n_kernel == (cfg.n_layers if S > 1 else 0)
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= DENSE_PREFILL_TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 40, 7])
def test_cuda_dense_ssm_prefill_runs_the_ssd_kernel(S):
    """mamba2's batched prefill on the card: ``auto`` runs the SSD kernel
    once a layer and matches ``impl="ref"``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.ssd_scan import kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _smoke_model("mamba2-370m", "float32")
    out = _prefill_paths(cfg, params, 2, S, ("ref", "auto"),
                         lambda: kernel.launches)
    (want, n_plain), (got, n_kernel) = out["ref"], out["auto"]
    assert n_plain == 0 and n_kernel == cfg.n_layers
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-4, err


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m"])
def test_cuda_dense_engine_launch_counts(arch):
    """``Engine`` on the card: a batched prefill and an insert each run
    the path's kernel once a layer; a decode step runs neither (dense
    decode is plain, as in the reference)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.serve import Engine
    cfg, params = _smoke_model(arch, "bfloat16")

    def count():
        return fa.launches["flash_attention"] + ssd.launches

    eng = Engine(cfg, params, batch=2, max_len=64)
    rng = np.random.default_rng(0)
    steps = []
    before = count()
    lg = eng.prefill(rng.integers(0, cfg.vocab_size - 1, (2, 24)))
    steps.append(count() - before)
    before = count()
    eng.insert(1, rng.integers(0, cfg.vocab_size - 1, (1, 16)), true_len=11)
    steps.append(count() - before)
    before = count()
    lg = eng.decode(np.zeros((2, 1), np.int32))
    steps.append(count() - before)
    assert steps == [cfg.n_layers, cfg.n_layers, 0]
    assert eng.cache["len"].tolist() == [25, 12]
    assert torch.isfinite(lg.float()).all()


@pytest.mark.cuda
def test_cuda_two_group_failover_runs_the_paged_kernel():
    """Two device groups on the card with a ``kill_group`` plan: group 1
    fails mid-trace and rejoins by a probe of the card, every request
    completes, both groups end leak-free, and the paged kernel runs once a
    layer in every decode step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.core.fault import ServeChaosInjector
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.serve import PagedEngine, ServeScheduler
    cfg, params = _smoke_model("qwen2-1.5b", "float32")
    eng = PagedEngine(cfg, params, batch=4, max_len=64, page_size=8,
                      prefill_chunk=16)
    chaos = ServeChaosInjector(kill_group=(1, 3, 6))
    sched = ServeScheduler(eng, device_groups=2, reserve="demand",
                           probe_interval_steps=2, chaos=chaos)
    rng = np.random.default_rng(0)
    for n, max_new in [(5, 4), (11, 6), (19, 4), (30, 6), (5, 6), (19, 6)]:
        sched.submit(rng.integers(0, cfg.vocab_size - 1, (n,)), max_new)
    steps0, launches0 = eng.n_decode_calls, kernel.launches
    results = sched.run()
    while not all(g.healthy for g in sched.groups):
        sched.step()
    steps = eng.n_decode_calls - steps0
    assert len(results) == 6
    assert {o.outcome for o in sched.outcomes.values()} == {"completed"}
    assert chaos.n_kills == 1
    assert sched.n_group_failovers == 1 and sched.n_group_rejoins == 1
    assert sched.resume_tokens_recomputed > 0
    assert all(g.allocator.n_outstanding == 0 for g in sched.groups)
    assert steps > 0 and kernel.launches - launches0 == steps * cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "zamba2-1.2b"])
def test_cuda_moe_and_hybrid_engines_run_their_kernels(arch):
    """qwen2-moe and zamba2 (smoke widths, fp32) on the card: a paged
    decode step runs the paged kernel once an attention layer (every MoE
    block; every invocation of zamba2's shared block), a prefill chunk
    runs SSD once an SSM layer, the dense engine's batched prefill runs
    the flash forward once an attention layer and SSD once an SSM layer;
    the paged kernel's decode logits match the gather path's, and the
    batched prefill's match ``impl="ref"``'s (plain attention and SSD)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.models.transformer import layer_kinds
    from repro_torch.serve import PagedEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _smoke_model(arch, "float32")
    kinds = layer_kinds(cfg)
    n_ssm = kinds.count("ssm")
    n_attn = len(kinds) - n_ssm
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size - 1, (40,))
    logits = {}
    for impl in ("kernel", "ref"):
        eng = PagedEngine(cfg, params, batch=2, max_len=64, page_size=8,
                          prefill_chunk=16, attn_impl=impl)
        before = ssd.launches
        first = eng.insert(0, prompt, page_ids=list(range(1, 8)), max_new=8)
        chunks = eng.n_chunk_calls
        if impl == "kernel":
            assert ssd.launches - before == chunks * n_ssm
        before = pa.launches
        toks = np.zeros((2, 1), np.int32)
        toks[0, 0] = int(first[0, -1].argmax())
        out = [first[0, -1]]
        for _ in range(3):
            lg = eng.decode(toks, live_mask=np.array([True, False]))
            out.append(lg[0, -1])
            toks[0, 0] = int(lg[0, -1].argmax())
        torch.cuda.synchronize()
        assert pa.launches - before == (3 * n_attn if impl == "kernel"
                                        else 0)
        logits[impl] = torch.stack(out).float()
    got, want = logits["kernel"], logits["ref"]
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    out = _prefill_paths(cfg, params, 2, 40, ("ref", "auto"),
                         lambda: np.array([fa.launches["flash_attention"],
                                           ssd.launches]))
    (want, n_plain), (got, n_kernel) = out["ref"], out["auto"]
    assert n_plain.tolist() == [0, 0]
    assert n_kernel.tolist() == [n_attn, n_ssm]
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_gemma3_engines_run_their_kernels():
    """gemma3 (smoke widths, window 16, fp32) on the card: a paged decode
    step runs the paged kernel once a layer, local and global alike, and
    matches the gather path; the dense engine's batched prefill of 40
    tokens (past the window) runs the flash forward once a layer and
    matches ``impl="ref"``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.paged_attention import kernel as pa
    from repro_torch.serve import PagedEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _smoke_model("gemma3-4b", "float32")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size - 1, (40,))
    logits = {}
    for impl in ("kernel", "ref"):
        eng = PagedEngine(cfg, params, batch=2, max_len=64, page_size=8,
                          prefill_chunk=16, attn_impl=impl)
        first = eng.insert(0, prompt, page_ids=list(range(1, 8)), max_new=8)
        before = pa.launches
        toks = np.zeros((2, 1), np.int32)
        toks[0, 0] = int(first[0, -1].argmax())
        out = [first[0, -1]]
        for _ in range(4):
            lg = eng.decode(toks)
            out.append(lg[0, -1])
            toks[0, 0] = int(lg[0, -1].argmax())
        torch.cuda.synchronize()
        assert pa.launches - before == (4 * cfg.n_layers if impl == "kernel"
                                        else 0)
        logits[impl] = torch.stack(out).float()
    got, want = logits["kernel"], logits["ref"]
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    out = _prefill_paths(cfg, params, 2, 40, ("ref", "auto"),
                         lambda: fa.launches["flash_attention"])
    (want, n_plain), (got, n_kernel) = out["ref"], out["auto"]
    assert (n_plain, n_kernel) == (0, cfg.n_layers)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_whisper_engine_runs_the_flash_kernel():
    """whisper (smoke widths, fp32) on the card's dense engine: a batched
    prefill runs the flash forward once an encoder layer, twice a decoder
    layer (self- and cross-attention), an insert the same, a decode step
    once a decoder layer (cross-attention over the frames; the S == 1
    self-attention is plain); the logits match ``impl="ref"``'s path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models.transformer import decode_step, encode, init_cache
    from repro_torch.serve import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _smoke_model("whisper-base", "float32")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size - 1, (2, 9)).astype(np.int32)
    enc = rng.standard_normal((2, 40, cfg.d_model), dtype=np.float32)
    count = lambda: fa.launches["flash_attention"]
    per_prefill = cfg.n_encoder_layers + 2 * cfg.n_layers
    eng = Engine(cfg, params, batch=2, max_len=32)
    before = count()
    eng.prefill(toks, enc_embeds=enc)
    assert count() - before == per_prefill
    before = count()
    eng.insert(1, toks[:1, :5], enc_embeds=enc[:1])
    assert count() - before == per_prefill
    before = count()
    lg = eng.decode(toks[:, :1])
    assert count() - before == cfg.n_layers
    assert torch.isfinite(lg.float()).all()
    # the kernel path against the plain one, prefill then a decode step
    out = {}
    for impl in ("auto", "ref"):
        e = encode(cfg, eng.params, torch.as_tensor(enc, device="cuda"),
                   impl=impl)
        cache = init_cache(cfg, 2, 32, device="cuda")
        t = torch.as_tensor(toks, device="cuda")
        a, cache = decode_step(cfg, eng.params, cache, t, impl=impl,
                               enc_out=e)
        b, _ = decode_step(cfg, eng.params, cache, t[:, :1], impl=impl,
                           enc_out=e)
        out[impl] = torch.cat([a[:, -1], b[:, -1]]).float()
    got, want = out["auto"], out["ref"]
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_mesh_engine_on_one_card():
    """qwen2 smoke (fp32) served by a TP=2 x DP=2 mesh with every grid
    position on cuda:0: the streams equal the meshless engine's, no group
    leaks a page, TP=2 halves the per-position pool bytes, and the paged
    kernel runs once a layer a decode step on each row's each shard."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.serve import PagedEngine, ServeScheduler
    from repro_torch.serve.mesh import MeshSpec, build_serve_mesh
    cfg, params = _smoke_model("qwen2-1.5b", "float32")

    def run(mesh, groups):
        eng = PagedEngine(cfg, params, batch=4, max_len=64, page_size=8,
                          num_pages=26, prefill_chunk=16, mesh=mesh)
        sched = ServeScheduler(eng, reserve="demand", device_groups=groups)
        rng = np.random.default_rng(7)
        for _ in range(8):
            sched.submit(rng.integers(1, 50, 12), 6)
        steps0, launches0 = eng.n_decode_calls, kernel.launches
        results = sched.run()
        assert all(g.allocator.n_outstanding == 0 for g in sched.groups)
        return ({r.rid: r.tokens for r in results},
                eng.n_decode_calls - steps0, kernel.launches - launches0,
                eng.per_device_pool_bytes())

    base, _, _, base_bytes = run(None, 1)
    mesh = build_serve_mesh(MeshSpec(tp=2, dp=2),
                            devices=[torch.device("cuda:0")] * 4)
    streams, steps, launches, nbytes = run(mesh, 2)
    assert streams == base
    assert steps > 0 and launches == steps * cfg.n_layers * 2 * 2
    tp2 = build_serve_mesh(MeshSpec(tp=2, dp=1),
                           devices=[torch.device("cuda:0")] * 2)
    assert 2 * run(tp2, 1)[3] == base_bytes


# the training mesh's flash shapes for qwen2-1.5b at seq 4096: a TP=2
# shard's heads (H 6, KV 1: G 6) at a micro-batch of 2, a DP=2 row's
# micro-batch of 1 at the whole heads (H 12, KV 2), and a TP=2 x DP=2
# row's shard at micro-batch 1
FA_TP_SHARD_CASES = [(2, 4096, 4096, 6, 1, 128, True, None),
                     (1, 4096, 4096, 12, 2, 128, True, None),
                     (1, 4096, 4096, 6, 1, 128, True, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_TP_SHARD_CASES)
def test_cuda_flash_kernels_at_a_train_mesh_shard(case):
    """Both flash kernels at the shapes the training mesh gives them: the
    forward in bf16 within 2e-2 of its plain version (LSE 1e-4), the
    backward in fp32 within 1e-4 of max|plain|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_kernel, flash_attention_backward_plain,
        flash_attention_kernel, flash_attention_plain)
    B, S, T, H, KV, D, causal, window = case
    q, k, v = fa_case(29, B, S, T, H, KV, D, "bfloat16")
    out, lse = flash_attention_kernel(q, k, v, causal=causal, window=window)
    out_p, lse_p = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
    torch.testing.assert_close(out.float(), out_p.float(),
                               atol=FA_TOL["bfloat16"],
                               rtol=FA_TOL["bfloat16"])
    torch.testing.assert_close(lse, lse_p, atol=FA_LSE_TOL, rtol=FA_LSE_TOL)
    q, k, v, dout = _fa_bwd_inputs(case, "float32")
    out, lse = flash_attention_kernel(q, k, v, causal=causal, window=window)
    got = flash_attention_backward_kernel(q, k, v, out, lse, dout,
                                          causal=causal, window=window)
    want = flash_attention_backward_plain(q, k, v, out, lse, dout,
                                          causal=causal, window=window)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and _rel(g, w) <= FA_BWD_TOL["float32"]


@pytest.mark.cuda
def test_cuda_train_mesh_step_on_one_card():
    """One fused step (2 micro-batches) of the qwen2 smoke config in fp32
    on a TP=2 x DP=2 training mesh with every position on cuda:0: the
    flash forward runs micro-batches x layers x 2 (remat) x tp x dp times,
    its backward micro-batches x layers x tp x dp, and the parameters, the
    loss and the grad norm are the meshless step's (1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.data import DataConfig, SyntheticLMStream, to_device
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import OptimizerSpec
    from repro_torch.parallel.partition import gather_tree
    from repro_torch.train import TrainState, make_train_step, shard_state
    from repro_torch.tree import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, _ = _smoke_model("qwen2-1.5b", "float32")
    spec = OptimizerSpec(lr=1e-3, eps=1e-6)
    batch = to_device(SyntheticLMStream(cfg, DataConfig(
        global_batch=4, seq_len=200)).batch(0), "cuda")
    mesh = make_test_mesh(2, 2, device="cuda",
                          devices=[torch.device("cuda:0")] * 4)
    fresh = TrainState.create(cfg, spec, torch.Generator("cuda").manual_seed(
        0), "cuda")
    plain = TrainState(params=tree_map(torch.clone, fresh.params),
                       opt_state=tree_map(torch.clone, fresh.opt_state))
    placed = shard_state(fresh, mesh)
    plain, m_p = make_train_step(cfg, spec, grad_accum=2)(plain, batch)
    before = dict(kernel.launches)
    placed, m = make_train_step(cfg, spec, grad_accum=2, mesh=mesh)(placed,
                                                                    batch)
    torch.cuda.synchronize()
    assert kernel.launches == {
        "flash_attention": (before["flash_attention"]
                            + 2 * cfg.n_layers * 2 * 4),
        "flash_attention_bwd": (before["flash_attention_bwd"]
                                + 2 * cfg.n_layers * 4)}
    got = tree_leaves(gather_tree(placed.params))
    want = tree_leaves(plain.params)
    scale = max(float(w.abs().max()) for w in want)
    assert max(float((g - w).abs().max())
               for g, w in zip(got, want)) <= 1e-5 * scale
    assert abs(float(m["loss_total"]) / float(m_p["loss_total"]) - 1) < 1e-5
    assert abs(float(m["grad_norm"]) / float(m_p["grad_norm"]) - 1) < 1e-5


@pytest.mark.cuda
def test_cuda_moe_train_mesh_step1_matches_no_mesh():
    """Step 1 (2 micro-batches) of the qwen2-moe smoke config in fp32 at
    TP=2, both positions on cuda:0 (its 8 experts split 4 / 4, its
    vocabulary in halves), against the meshless step 1: the loss, the
    grad norm and every gradient leaf within 1e-5 (of max|g| for the
    leaves); the flash forward runs micro-batches x layers x 2 (remat) x
    tp times.  In bf16 at these smoke widths the router's gradient alone
    moves 0.12 of its max|g| with a TP split's rounding, so the bf16
    gates are held at full width (``chip_smoke.py`` ``train_mesh_moe``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.data import DataConfig, SyntheticLMStream, to_device
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.moe import expert_axis
    from repro_torch.optim import global_norm
    from repro_torch.parallel.partition import gather_tree, place_state
    from repro_torch.train import compute_grads, compute_grads_mesh
    from repro_torch.tree import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _smoke_model("qwen2-moe-a2.7b", "float32")
    assert expert_axis(params["layers"][0]["moe"], 2) == "experts"
    batch = to_device(SyntheticLMStream(cfg, DataConfig(
        global_batch=4, seq_len=200)).batch(0), "cuda")
    grads, loss, _ = compute_grads(cfg, params, batch, accum=2)
    mesh = make_test_mesh(1, 2, device="cuda",
                          devices=[torch.device("cuda:0")] * 2)
    placed = place_state({"params": params}, mesh)["params"]
    before = dict(kernel.launches)
    mgrads, mloss, _ = compute_grads_mesh(cfg, placed, batch, mesh, accum=2)
    torch.cuda.synchronize()
    assert kernel.launches["flash_attention"] == (
        before["flash_attention"] + 2 * cfg.n_layers * 2 * 2)
    assert abs(float(mloss) / float(loss) - 1) <= 1e-5
    assert abs(float(global_norm(mgrads)) / float(global_norm(grads))
               - 1) <= 1e-5
    got, want = tree_leaves(gather_tree(mgrads)), tree_leaves(grads)
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * scale
