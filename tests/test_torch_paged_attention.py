"""The port's paged flash-decode module against the JAX package.

Inputs come from numpy with a fixed seed and go through both sides: the
JAX wrapper with ``impl="interpret"`` (the Pallas kernel body, interpreted)
and ``impl="ref"`` (the gather oracle), and the port's wrapper on CPU
tensors (its plain versions).  The kernel-level plain function is held
against the interpreted Pallas kernel's raw (acc, m, l), and so is the
CUDA kernel's split plan (the per-split partials of
``paged_attention_split_plain``, merged by ``merge_splits_plain``) at
every pages-a-split value of the tuner's grid, with and without the
current token's self term.  Tolerance 2e-6 (fp32; the two sides sum in
different orders).  The CUDA kernel itself is held against its plain
version in ``test_torch_kernels_cuda.py``, on the card.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import \
    paged_attention_kernel as jax_paged_kernel
from repro.kernels.paged_attention.ops import \
    paged_decode_attention as jax_paged_decode
from repro_torch.kernels.paged_attention import (merge_splits_plain,
                                                 paged_attention_plain,
                                                 paged_attention_split_plain,
                                                 paged_decode_attention,
                                                 paged_decode_kernel)
from repro_torch.kernels.paged_attention.kernel import \
    default_pages_per_split
from repro_torch.kernels.runtime import resolve_impl
from repro_torch.kernels.tuning import DEFAULT_CANDIDATES
from test_torch_kernels_cuda import PA_CASES, SPLIT_CASES, paged_case

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


# ---------------------------------------------------------------------------
# the CUDA kernel's split plan (split pass, merge pass) against the JAX
# package
# ---------------------------------------------------------------------------

PPS_GRID = [c["pages_per_split"] for c in DEFAULT_CANDIDATES["paged_attention"]]
ALL_CASES = PA_CASES + SPLIT_CASES


@functools.lru_cache(maxsize=None)
def _jax_side(i):
    """Case ``i``'s numpy inputs, its pre-scaled grouped q (the port's
    wrapper's rounding), the interpreted Pallas kernel's raw (acc, m, l)
    and the JAX wrapper's output at ``interpret`` and ``ref``."""
    B, H, KV, D, ps, n, lens, window, share, trash = ALL_CASES[i]
    arrays = paged_case(17, B, H, KV, D, ps, n, lens, share=share,
                        trash_tail=trash)
    q = arrays[0]
    G = H // KV
    qg = torch.from_numpy(q).reshape(B, KV, G, D) * (1.0 / math.sqrt(D))
    g_pad = -(-G // 8) * 8
    qp = np.pad(qg.numpy(), ((0, 0), (0, 0), (0, g_pad - G), (0, 0)))
    acc, m, l = jax_paged_kernel(
        jnp.asarray(qp), *map(jnp.asarray, arrays[1:5]), window=window,
        interpret=True)
    raw = (np.asarray(acc)[:, :, :G], np.asarray(m)[:, :, :G, 0],
           np.asarray(l)[:, :, :G, 0])
    dec = {impl: np.asarray(_jax_decode(*map(jnp.asarray, arrays),
                                        window=window, impl=impl))
           for impl in ("interpret", "ref")}
    return arrays, qg, raw, dec


@pytest.mark.parametrize("pps", PPS_GRID)
@pytest.mark.parametrize("i", range(len(ALL_CASES)),
                         ids=[f"case{i}" for i in range(len(ALL_CASES))])
def test_split_plan_matches_pallas_kernel_outputs(i, pps):
    """merge_splits_plain(paged_attention_split_plain(...)) gives the
    Pallas kernel's (acc, m, l): splitting the page walk and merging the
    splits by log-sum-exp changes nothing but the summation order."""
    arrays, qg, raw, _ = _jax_side(i)
    window = ALL_CASES[i][7]
    _, kp, vp, tbl, kv_len, _, _ = _torch(*arrays)
    parts = paged_attention_split_plain(qg, kp, vp, tbl, kv_len, window,
                                        pages_per_split=pps)
    n_split = -(-tbl.shape[1] // pps)
    assert parts[0].shape[2] == parts[1].shape[2] == n_split
    got = merge_splits_plain(*parts)
    for g, w in zip(got, raw):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("pps", PPS_GRID)
@pytest.mark.parametrize("i", range(len(ALL_CASES)),
                         ids=[f"case{i}" for i in range(len(ALL_CASES))])
def test_split_plan_with_self_term_matches_jax_wrapper(i, pps):
    """The merge pass with the current token's kt/vt gives the JAX
    wrapper's output, at ``impl="interpret"`` and ``impl="ref"``."""
    arrays, qg, _, dec = _jax_side(i)
    window = ALL_CASES[i][7]
    _, kp, vp, tbl, kv_len, kt, vt = _torch(*arrays)
    parts = paged_attention_split_plain(qg, kp, vp, tbl, kv_len, window,
                                        pages_per_split=pps)
    got = merge_splits_plain(*parts, q=qg, kt=kt, vt=vt).numpy()
    assert np.isfinite(got).all()
    for impl, want in dec.items():
        np.testing.assert_allclose(got, want, **TOL, err_msg=impl)


def test_empty_splits_are_empty_and_merge_to_nothing():
    """A free slot (kv_len 0): every split is m = NEG_INF, l = 0, acc = 0,
    and so is the merge, never NaN; a split past a slot's length is empty
    too."""
    from repro_torch.kernels.paged_attention.ref import NEG_INF
    q, kp, vp, tbl, kv_len, _, _ = paged_case(18, 2, 4, 2, 32, 8, 6, (0, 20))
    qg = torch.from_numpy(q).reshape(2, 2, 2, 32) / math.sqrt(32)
    acc_s, m_s, l_s = paged_attention_split_plain(
        qg, *_torch(kp, vp, tbl, kv_len), pages_per_split=2)
    assert (m_s[0] == NEG_INF).all() and (l_s[0] == 0).all()
    assert (acc_s[0] == 0).all()
    # slot 1 holds 20 positions: pages 0-2 run, so split 2 (pages 4, 5)
    # is empty
    assert (m_s[1, :, 2] == NEG_INF).all() and (l_s[1, :, 2] == 0).all()
    acc, m, l = merge_splits_plain(acc_s, m_s, l_s)
    assert (m[0] == NEG_INF).all() and (l[0] == 0).all()
    assert (acc[0] == 0).all() and torch.isfinite(acc).all()


def test_default_pages_per_split_fills_two_waves():
    """The serving shape (B 8, KV 2, 128 pages a slot) splits by 4 pages:
    512 blocks, at least two a Hopper SM; short tables split finer, down
    to one page a split."""
    assert default_pages_per_split(8, 2, 128) == 4
    assert default_pages_per_split(8, 2, 4096) == 16
    assert default_pages_per_split(1, 1, 3) == 1
    for B, KV, n in ((8, 2, 128), (4, 8, 64), (2, 2, 1000)):
        pps = default_pages_per_split(B, KV, n)
        assert B * KV * -(-n // pps) >= 264 or pps == 1
        assert pps in PPS_GRID


def test_kernel_entry_points_refuse_cpu_tensors():
    """The kernels have no CPU mode: handed CPU tensors they raise before
    building or launching anything, and ``impl="ref"`` takes and ignores
    a pages-a-split value."""
    q, kp, vp, tbl, kv_len, kt, vt = _torch(
        *paged_case(19, 2, 4, 2, 32, 8, 3, (9, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_kernel(q, kp, vp, tbl, kv_len, kt, vt, scale=0.25)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention(q, kp, vp, tbl, kv_len, kt, vt,
                               impl="kernel", pages_per_split=2)
    want = paged_decode_attention(q, kp, vp, tbl, kv_len, kt, vt)
    got = paged_decode_attention(q, kp, vp, tbl, kv_len, kt, vt,
                                 impl="ref", pages_per_split=2)
    assert torch.equal(got, want)
