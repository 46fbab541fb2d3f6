"""Parity of the port's flash-attention plain version, its gradient, the
tiled attention path and the cache-less attention layer against the JAX
package, on the CPU.

Inputs come from numpy seeds and pass between the frameworks as numpy
arrays.  The JAX side runs as its own tests run it: ``attention_ref`` and
the Pallas kernel in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import attention as jattn
from repro.models.attention import init_attention as jax_init_attention
from repro.models.config import ModelConfig as JaxConfig
from repro.kernels.tuning import DEFAULT_CANDIDATES as JAX_CANDIDATES
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn, flash_attention, flash_attention_backward_kernel,
    flash_attention_backward_plain, flash_attention_plain, ops)
from repro_torch.kernels.tuning import DEFAULT_CANDIDATES
from repro_torch.models import attention as tattn
from repro_torch.models.config import ModelConfig as TorchConfig

# B, S, H, KV, D, causal, window, qb, kb — the JAX package's FA_CASES
# (tests/test_kernels.py)
FA_CASES = [
    (1, 128, 4, 4, 64, True, None, 64, 64),
    (2, 256, 4, 2, 64, True, None, 128, 128),
    (1, 512, 8, 2, 32, True, 64, 128, 64),
    (2, 256, 8, 8, 32, False, None, 256, 64),
    (1, 384, 4, 1, 64, True, 100, 128, 128),
    (1, 256, 2, 2, 128, True, None, 64, 256),
]
FA_TOL = {"float32": 2e-6, "bfloat16": 2e-2}   # the reference's own


def qkv(seed, B, S, T, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, T, KV, D)).astype(np.float32),
            rng.standard_normal((B, T, KV, D)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES)
def test_plain_matches_jax_oracle_and_interpreted_kernel(case, dtype):
    B, S, H, KV, D, causal, window, qb, kb = case
    q, k, v = qkv(30, B, S, S, H, KV, D)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    ref = jax_flash(jq, jk, jv, causal=causal, window=window, impl="ref")
    ker = jax_flash(jq, jk, jv, causal=causal, window=window,
                    impl="interpret", q_block=qb, kv_block=kb)
    tq, tk, tv = (t.to(getattr(torch, dtype)) for t in _t(q, k, v))
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal,
                                     window=window)
    assert out.dtype == tq.dtype and lse.shape == (B, H, S)
    tol = FA_TOL[dtype]
    got = out.float().numpy()
    for want in (ref, ker):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_plain_lse_is_the_log_of_the_softmax_denominator():
    B, S, H, KV, D = 2, 70, 4, 2, 32
    q, k, _ = _t(*qkv(31, B, S, S, H, KV, D))
    _, lse = flash_attention_plain(q, k, k, causal=True, window=20)
    s = torch.einsum("bshd,bthd->bhst", q,
                     k.repeat_interleave(2, dim=2)) / np.sqrt(D)
    pos = torch.arange(S)
    ok = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < 20)
    want = torch.logsumexp(s.masked_fill(~ok, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)


def test_rows_with_no_visible_key_are_zero_and_finite():
    """S > T with a window: the late rows see no key.  The reference only
    promises finite values there (tests/test_kernels.py:48); the port gives
    zeros and an LSE of NEG_INF, and the gradient stays finite."""
    q, k, v = (t.requires_grad_() for t in _t(*qkv(32, 1, 100, 40, 2, 2,
                                                    32)))
    out, lse = FlashAttentionFn.apply(q, k, v, True, 16, "ref")
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (out[0, 55:] == 0).all() and (lse[..., 55:] < -1e38).all()
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    assert all(torch.isfinite(g).all() for g in grads)
    # a window of one: every row sees only itself, as in the JAX test
    q, k, v = _t(*qkv(33, 1, 256, 256, 2, 2, 32))
    out, _ = flash_attention_plain(q, k, v, causal=True, window=1)
    torch.testing.assert_close(out, v, atol=1e-6, rtol=1e-6)


GRAD_CASES = [
    # B, S, T, H, KV, D, causal, window, q_tile of the backward
    (2, 40, 40, 4, 2, 24, True, None, 1024),
    (1, 64, 64, 4, 1, 32, True, 9, 16),
    (2, 33, 33, 6, 3, 16, False, None, 8),
    (1, 50, 50, 2, 2, 8, False, 7, 12),
    # head dim 256 (gemma3): causal GQA; a window of 16 with S > T (every
    # row still sees a key, where the reference's oracle is defined);
    # non-causal
    (2, 40, 40, 4, 2, 256, True, None, 16),
    (1, 48, 40, 4, 2, 256, True, 16, 16),
    (2, 33, 33, 2, 2, 256, False, None, 1024),
]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_flash_fn_gradients_match_torch_and_jax(case):
    """The plain backward (``ref.flash_attention_backward_plain``) and
    ``FlashAttentionFn``'s backward (plain forward on the CPU) against
    torch autograd through ``_dense_attn`` and ``jax.grad`` of JAX's
    ``attention_ref``, at 1e-5."""
    B, S, T, H, KV, D, causal, window, q_tile = case
    q, k, v = qkv(34, B, S, T, H, KV, D)
    dout = np.random.default_rng(35).standard_normal((B, S, H, D)).astype(
        np.float32)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out, lse = FlashAttentionFn.apply(tq, tk, tv, causal, window, "ref")
    grads = flash_attention_backward_plain(
        tq.detach(), tk.detach(), tv.detach(), out.detach(), lse,
        torch.from_numpy(dout), causal=causal, window=window, q_tile=q_tile)
    grads_fn = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))

    out_d = tattn._dense_attn(tq, tk, tv, torch.arange(S), torch.arange(T),
                              causal=causal, window=window)
    grads_d = torch.autograd.grad(out_d, (tq, tk, tv), torch.from_numpy(dout))

    def f(q_, k_, v_):
        o = attention_ref(q_.transpose(0, 2, 1, 3), k_.transpose(0, 2, 1, 3),
                          v_.transpose(0, 2, 1, 3), causal=causal,
                          window=window)
        return jnp.sum(o.transpose(0, 2, 1, 3) * dout)
    grads_j = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    for g, gf, gd, gj in zip(grads, grads_fn, grads_d, grads_j):
        np.testing.assert_allclose(g.numpy(), gf.numpy(), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(g.numpy(), gd.numpy(), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-5,
                                   rtol=1e-5)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    from repro_torch.kernels.flash_attention import kernel
    q, k, v = _t(*qkv(36, 1, 20, 20, 2, 1, 16))
    before = dict(kernel.launches)
    out = flash_attention(q, k, v, causal=True)
    assert kernel.launches == before
    torch.testing.assert_close(out, flash_attention_plain(q, k, v)[0])
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v, impl="kernel")


def test_flash_fn_on_the_cpu_routes_ref_to_the_plain_backward(monkeypatch):
    """``impl="ref"`` picks both plain halves: the backward runs
    ``flash_attention_backward_plain`` (counted here), never the kernel."""
    from repro_torch.kernels.flash_attention import kernel
    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        return flash_attention_backward_plain(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("the backward kernel ran on the CPU")

    monkeypatch.setattr(ops, "flash_attention_backward_plain", spy)
    monkeypatch.setattr(ops, "flash_attention_backward_kernel", refuse)
    q, k, v = (t.requires_grad_() for t in _t(*qkv(39, 1, 30, 30, 4, 2,
                                                    16)))
    before = dict(kernel.launches)
    out = flash_attention(q, k, v, causal=True, window=7)
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    assert calls == [{"causal": True, "window": 7}]
    assert kernel.launches == before
    _, lse = flash_attention_plain(q, k, v, causal=True, window=7)
    want = flash_attention_backward_plain(
        q.detach(), k.detach(), v.detach(), out.detach(), lse,
        torch.ones_like(out), causal=True, window=7)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


# what the backward binding refuses, each before any build: name, the
# change to the default (q (1, 16, 2, D 32) fp32, k/v (1, 16, 2, 32))
BWD_REFUSED = [
    ("cpu", {}, ValueError, "CUDA tensor"),
    ("mixed_dtype", {"k": torch.bfloat16}, TypeError, "differs"),
    ("d264", {"D": 264}, ValueError, "head dim"),
    ("d20", {"D": 20}, ValueError, "head dim"),
    ("half", {"all": torch.float16}, TypeError, "not supported"),
    ("lse_dtype", {"lse": torch.bfloat16}, TypeError, "lse"),
]


@pytest.mark.parametrize("case", BWD_REFUSED, ids=[c[0] for c in BWD_REFUSED])
def test_backward_binding_refuses_before_any_build(case, monkeypatch):
    _, change, exc, match = case

    def no_build(name):
        raise AssertionError(f"built {name} before checking its inputs")

    monkeypatch.setattr(build, "build", no_build)
    D = change.get("D", 32)
    q, k, v = _t(*qkv(40, 1, 16, 16, 2, 2, D))
    if "all" in change:
        q, k, v = (t.to(change["all"]) for t in (q, k, v))
    if "k" in change:
        k = k.to(change["k"])
    out, dout = torch.zeros_like(q), torch.ones_like(q)
    lse = torch.zeros((1, 2, 16), dtype=change.get("lse", torch.float32))
    with pytest.raises(exc, match=match):
        flash_attention_backward_kernel(q, k, v, out, lse, dout, causal=True)


def test_launch_shape_arguments_on_the_cpu():
    """``q_block``/``kv_block`` of the grid leave the plain version's
    result unchanged, in the forward and the gradient; values outside the
    grid are refused on either path."""
    q, k, v = (t.requires_grad_() for t in _t(*qkv(41, 2, 40, 40, 4, 2,
                                                    16)))
    want = flash_attention(q, k, v, causal=True)
    want_g = torch.autograd.grad(want.sum(), (q, k, v))
    for cfg in DEFAULT_CANDIDATES["flash_attention"]:
        got = flash_attention(q, k, v, causal=True, **cfg)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        for g, w in zip(torch.autograd.grad(got.sum(), (q, k, v)), want_g):
            torch.testing.assert_close(g, w, atol=0, rtol=0)
    for bad in ({"q_block": 32}, {"kv_block": 256}, {"q_block": 96,
                                                     "kv_block": 64}):
        with pytest.raises(ValueError, match="launch shapes"):
            flash_attention(q, k, v, causal=True, **bad)
        with pytest.raises(ValueError, match="launch shapes"):
            flash_attention(q, k, v, causal=True, impl="ref", **bad)
    assert ops.launch_shape(q.detach(), 64, 128) == (64, 128)


def test_flash_tuner_grid_has_the_reference_key_names():
    """The port's flash grid: the four (q_block, kv_block) launch shapes,
    keyed by the names the reference's grid uses."""
    grid = DEFAULT_CANDIDATES["flash_attention"]
    assert sorted((c["q_block"], c["kv_block"]) for c in grid) == [
        (64, 64), (64, 128), (128, 64), (128, 128)]
    want = {frozenset(c) for c in JAX_CANDIDATES["flash_attention"]}
    assert {frozenset(c) for c in grid} == want == {
        frozenset({"q_block", "kv_block"})}


TILED_CASES = [
    # B, S, H, KV, D, causal, window, q_tile, kv_tile
    (2, 64, 4, 2, 16, True, None, 16, 16),
    (1, 77, 4, 1, 24, True, None, 32, 16),
    (1, 90, 2, 2, 16, True, 20, 16, 8),
    (2, 50, 6, 3, 8, True, 5, 8, 16),
    (1, 64, 4, 2, 16, False, None, 16, 32),
]


@pytest.mark.parametrize("case", TILED_CASES)
def test_tiled_attention_matches_jax(case):
    """The port's ``_tiled_attn`` against JAX's ``_tiled_attn`` (same tiles)
    and ``_dense_attn``: causal, windowed, ragged; 1e-5."""
    B, S, H, KV, D, causal, window, qt, kt = case
    q, k, v = qkv(37, B, S, S, H, KV, D)
    pos = np.arange(S)
    jt = jattn._tiled_attn(*(jnp.asarray(a) for a in (q, k, v)),
                           jnp.asarray(pos), jnp.asarray(pos), causal=causal,
                           window=window, q_tile=qt, kv_tile=kt)
    jd = jattn._dense_attn(*(jnp.asarray(a) for a in (q, k, v)),
                           jnp.asarray(pos), jnp.asarray(pos), causal=causal,
                           window=window)
    tpos = torch.from_numpy(pos)
    got = tattn._tiled_attn(*_t(q, k, v), tpos, tpos, causal=causal,
                            window=window, q_tile=qt, kv_tile=kt).numpy()
    np.testing.assert_allclose(got, np.asarray(jt), atol=1e-5, rtol=1e-5)
    if S % kt == 0 or causal:      # the reference's non-causal tiled path
        np.testing.assert_allclose(got, np.asarray(jd), atol=1e-5,
                                   rtol=1e-5)      # counts padded keys


def test_attention_impl_resolution():
    r = tattn.resolve_attn_impl
    assert r("auto", "cpu", 2048, 2048) == "dense"
    assert r("auto", "cpu", 4096, 4096) == "tiled"
    assert r("dense", "cpu", 4096, 4096) == "dense"
    assert r("tiled", "cpu", 16, 16) == "tiled"
    for impl in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="CUDA"):
            r(impl, "cpu", 16, 16)
    with pytest.raises(ValueError, match="unknown"):
        r("interpret", "cpu", 16, 16)


CFG_KW = dict(name="a", family="dense", n_layers=1, d_model=48, n_heads=4,
              n_kv_heads=2, d_ff=96, vocab_size=64, qkv_bias=True,
              compute_dtype="float32")


@pytest.mark.parametrize("impl", ["auto", "dense", "tiled"])
@pytest.mark.parametrize("window", [None, 6])
def test_cacheless_attention_layer_matches_jax(impl, window):
    """The whole attention layer (projections, RoPE, core, output) with no
    cache, against the reference's cache-less branch; 1e-5."""
    from repro_torch.weights import _tensors
    jcfg, tcfg = JaxConfig(**CFG_KW), TorchConfig(**CFG_KW)
    p = jax.tree.map(np.asarray, jax_init_attention(jax.random.PRNGKey(3),
                                                    jcfg))
    p = jax.tree.map(lambda a: a + np.float32(0.05), p)   # nonzero biases
    x = np.random.default_rng(38).standard_normal((2, 24, 48)).astype(
        np.float32)
    pos = np.arange(24)
    want, _ = jattn.attention(jcfg, p, jnp.asarray(x),
                              positions=jnp.asarray(pos), window=window,
                              impl="dense" if impl == "dense" else "auto")
    got, kv = tattn.attention(tcfg, _tensors(p, "cpu"), torch.from_numpy(x),
                              positions=torch.from_numpy(pos), cache=None,
                              window=window, impl=impl)
    assert kv is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the same layer's core through the flash Function's plain forward
    cfg_pos = torch.from_numpy(pos)
    tp = _tensors(p, "cpu")
    xt = torch.from_numpy(x)
    q = tattn.dense(tp["q"], xt, torch.float32).reshape(2, 24, 4, 12)
    k = tattn.dense(tp["k"], xt, torch.float32).reshape(2, 24, 2, 12)
    vv = tattn.dense(tp["v"], xt, torch.float32).reshape(2, 24, 2, 12)
    sin, cos = tattn.rope_freqs(tcfg, cfg_pos, 12)
    q, k = tattn.apply_rope(q, sin, cos), tattn.apply_rope(k, sin, cos)
    core = flash_attention(q, k, vv, causal=True, window=window)
    out = tattn.dense(tp["o"], core.reshape(2, 24, 48), torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_config_fixture_is_the_reference_dataclass():
    """The test configs build the same fields on both sides."""
    assert set(f.name for f in dataclasses.fields(JaxConfig)) == set(
        f.name for f in dataclasses.fields(TorchConfig))
