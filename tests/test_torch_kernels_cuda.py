"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

These tests need an NVIDIA GPU (sm_90a, nvcc): each is marked ``cuda`` and
skips without a CUDA device.  The file imports neither JAX nor the JAX
package, so it runs on the machine with the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

The input builder and the paged-attention cases are shared with the CPU
parity tests (``test_torch_paged_attention.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import paged_attention_plain

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
