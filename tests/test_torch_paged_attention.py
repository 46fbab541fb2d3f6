"""The port's paged flash-decode module against the JAX package.

Inputs come from numpy with a fixed seed and go through both sides: the
JAX wrapper with ``impl="interpret"`` (the Pallas kernel body, interpreted)
and ``impl="ref"`` (the gather oracle), and the port's wrapper on CPU
tensors (its plain versions).  The kernel-level plain function is held
against the interpreted Pallas kernel's raw (acc, m, l).  Tolerance
2e-6 (fp32; the two sides sum in different orders).  The CUDA kernel
itself is held against its plain version in ``test_torch_kernels_cuda.py``,
on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import \
    paged_attention_kernel as jax_paged_kernel
from repro.kernels.paged_attention.ops import \
    paged_decode_attention as jax_paged_decode
from repro_torch.kernels.paged_attention import (paged_attention_plain,
                                                 paged_decode_attention)
from repro_torch.kernels.runtime import resolve_impl
from test_torch_kernels_cuda import PA_CASES, paged_case

TOL = dict(atol=2e-6, rtol=2e-6)

_jax_decode = jax.jit(jax_paged_decode, static_argnames=("window", "impl"))


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", PA_CASES)
def test_paged_decode_attention_matches_jax(case):
    B, H, KV, D, ps, n, lens, window, share, trash = case
    arrays = paged_case(11, B, H, KV, D, ps, n, lens, share=share,
                        trash_tail=trash)
    got = paged_decode_attention(*_torch(*arrays), window=window).numpy()
    assert np.isfinite(got).all()
    for impl in ("ref", "interpret"):
        want = np.asarray(_jax_decode(*map(jnp.asarray, arrays),
                                      window=window, impl=impl))
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", PA_CASES)
def test_plain_matches_pallas_kernel_outputs(case):
    """(acc, m, l) before the self-term merge, against the Pallas kernel
    body run by the interpreter (its G padded to 8, m/l on 128 lanes)."""
    B, H, KV, D, ps, n, lens, window, share, trash = case
    q, kp, vp, tbl, kv_len, _, _ = paged_case(
        12, B, H, KV, D, ps, n, lens, share=share, trash_tail=trash)
    G = H // KV
    qg = (q.reshape(B, KV, G, D) / np.sqrt(D)).astype(np.float32)
    g_pad = -(-G // 8) * 8
    qp = np.pad(qg, ((0, 0), (0, 0), (0, g_pad - G), (0, 0)))
    acc_j, m_j, l_j = jax_paged_kernel(
        jnp.asarray(qp), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(kv_len), window=window, interpret=True)
    acc, m, l = paged_attention_plain(*_torch(qg, kp, vp, tbl, kv_len),
                                      window=window)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j)[:, :, :G], **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j)[:, :, :G, 0], **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_j)[:, :, :G, 0], **TOL)


def test_all_trash_slot_returns_its_own_value():
    """A free slot (kv_len 0, whole row on the NaN trash page) collapses
    onto the self term: out == vt, finite."""
    q, kp, vp, tbl, kv_len, kt, vt = paged_case(13, 2, 4, 2, 32, 8, 3, (0, 0))
    out = paged_decode_attention(*_torch(q, kp, vp, tbl, kv_len, kt, vt))
    out = out.numpy()
    assert np.isfinite(out).all()
    want = np.repeat(vt[:, :, 0, :], 2, axis=1)
    np.testing.assert_allclose(out[:, 0], want, atol=1e-6, rtol=1e-6)


def test_impl_resolution_follows_the_tensor_device():
    assert resolve_impl("auto", "cpu") == "ref"
    assert resolve_impl("auto", "cuda") == "kernel"
    assert resolve_impl("ref", "cuda") == "ref"
    with pytest.raises(ValueError):
        resolve_impl("kernel", "cpu")
    with pytest.raises(ValueError):
        resolve_impl("interpret", "cpu")
    q, kp, vp, tbl, kv_len, kt, vt = paged_case(14, 1, 2, 1, 8, 4, 2, (5,))
    with pytest.raises(ValueError):
        paged_decode_attention(*_torch(q, kp, vp, tbl, kv_len, kt, vt),
                               impl="kernel")
