"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

These tests need an NVIDIA GPU (sm_90a, nvcc): each is marked ``cuda`` and
skips without a CUDA device.  The file imports neither JAX nor the JAX
package, so it runs on the machine with the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

The input builder and the paged-attention cases are shared with the CPU
parity tests (``test_torch_paged_attention.py``); the SSD inputs follow
the JAX package's kernel test, with strongly negative decays added; the
Jacobi inputs follow ``apps/jacobi.py``'s ``make_system`` at ragged N,
N 1 and the paper's largest N.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.jacobi_sweep import (jacobi_sweep_plain,
                                              jacobi_sweep_residual_plain)
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.kernels.ssd_scan import ssd_intra_chunk_plain

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PA_CASES)
def test_cuda_kernel_matches_plain(case, dtype):
    """The hand-written kernel against its plain version, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    B, H, KV, D, ps, n, lens, window, share, trash = case
    q, kp, vp, tbl, kv_len, _, _ = paged_case(
        15, B, H, KV, D, ps, n, lens, share=share, trash_tail=trash)
    dt = getattr(torch, dtype)
    G = H // KV
    qg = torch.from_numpy(q.reshape(B, KV, G, D) / np.sqrt(D)).to(dt)
    args = [qg] + [t.to(dt) for t in _torch(kp, vp)] + _torch(tbl, kv_len)
    args = [a.cuda() for a in args]
    acc, m, l = paged_attention_kernel(*args, window=window)
    acc_p, m_p, l_p = paged_attention_plain(*args, window=window)
    torch.testing.assert_close(m, m_p, atol=1e-5, rtol=1e-5)
    # acc / l: the attention output before the self term (a slot with no
    # visible position has acc == l == 0 on both sides)
    torch.testing.assert_close(acc / l.clamp_min(1e-30)[..., None],
                               acc_p / l_p.clamp_min(1e-30)[..., None],
                               atol=1e-5, rtol=1e-5)


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


# BC, H, Q, P, N: the serving shape at the largest and smallest chunk
# buckets, several chunks at once, the CPU tests' Q = 8, and ragged
# shapes that leave every tile edge partial
SSD_CASES = [
    (1, 32, 256, 64, 128),
    (1, 32, 16, 64, 128),
    (8, 4, 256, 64, 128),
    (2, 2, 8, 16, 16),
    (3, 3, 100, 70, 130),
    (2, 1, 1, 8, 8),
]
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
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("case", SSD_CASES)
def test_cuda_ssd_kernel_matches_plain(case, strong):
    """The hand-written SSD kernel against its plain version, on the card;
    one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.ssd_scan import kernel, ssd_intra_chunk
    args = [t.cuda() for t in _torch(*ssd_case(17, *case, strong=strong))]
    before = kernel.launches
    y, S = ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    y_p, S_p = ssd_intra_chunk_plain(*args)
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    assert _rel(y, y_p) <= SSD_TOL and _rel(S, S_p) <= SSD_TOL


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
