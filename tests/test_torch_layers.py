"""The port's layers and attention functions against the JAX package's,
function by function, on the CPU.

Inputs are drawn with numpy from a fixed seed and handed to both sides;
fp32 throughout (``compute_dtype="float32"``, the smoke config
``qwen2-1.5b-smoke``: d 96, H 4, KV 2, hd 24).  Tolerance 1e-5 absolute
and relative: the two frameworks sum in different orders, and RoPE's
``pow``/``sin``/``cos`` may differ in the last ulp.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def cfgs():
    j = dataclasses.replace(jax_smoke("qwen2-1.5b"), compute_dtype="float32")
    t = dataclasses.replace(get_smoke_config("qwen2-1.5b"),
                            compute_dtype="float32")
    return j, t


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def test_configs_match_the_reference():
    from repro.configs import ARCHS, get_config as jget
    from repro_torch.configs import ARCHS as TARCHS, get_config
    assert TARCHS == ARCHS
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(jax_smoke(arch))
    assert get_config("qwen2-1.5b").padded_vocab == 152_064


def test_rmsnorm_dense_mlp(cfgs):
    jc, tc = cfgs
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, jc.d_model), np.float32)
    scale = rng.standard_normal((jc.d_model,), np.float32)
    (xj, xt), (sj, st) = _both(x), _both(scale)
    _close(tlayers.apply_norm(tc, {"scale": st}, xt),
           jlayers.apply_norm(jc, {"scale": sj}, xj))

    w = rng.standard_normal((jc.d_model, 40), np.float32)
    b = rng.standard_normal((40,), np.float32)
    (wj, wt), (bj, bt) = _both(w), _both(b)
    _close(tlayers.dense({"w": wt, "b": bt}, xt, torch.float32),
           jlayers.dense({"w": wj, "b": bj}, xj, jnp.float32))

    mlp = {k: rng.standard_normal(s, np.float32) * 0.1 for k, s in
           (("up", (jc.d_model, jc.d_ff)), ("gate", (jc.d_model, jc.d_ff)),
            ("down", (jc.d_ff, jc.d_model)))}
    pj = {k: {"w": jnp.asarray(v)} for k, v in mlp.items()}
    pt = {k: {"w": torch.from_numpy(v)} for k, v in mlp.items()}
    _close(tlayers.apply_mlp(tc, pt, xt), jlayers.apply_mlp(jc, pj, xj))


def test_rmsnorm_kernel_switch_raises_only_on_cuda(cfgs):
    """``use_kernel=True`` selects the RMSNorm kernel wrapper: on a CPU
    tensor it runs the plain version (as every wrapper does), which gives
    the plain norm; on a CUDA tensor it launches the kernel
    (``test_torch_kernels_cuda.py`` holds it there).  The name dates from
    before the kernel existed, when the switch raised on a CUDA tensor; it
    is kept so that the test keeps its identity, and nothing raises now."""
    _, tc = cfgs
    x = torch.randn(3, tc.d_model)
    p = {"scale": torch.ones(tc.d_model)}
    torch.testing.assert_close(tlayers.apply_norm(tc, p, x, use_kernel=True),
                               tlayers.apply_norm(tc, p, x))


def test_embed_unembed_padded_vocab(cfgs):
    jc, tc = cfgs
    rng = np.random.default_rng(1)
    table = rng.standard_normal((jc.padded_vocab, jc.d_model), np.float32)
    toks = rng.integers(0, jc.vocab_size, (2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 1, jc.d_model), np.float32)
    (tj, tt), (kj, kt), (xj, xt) = _both(table), _both(toks), _both(x)
    _close(tlayers.embed(tc, {"table": tt}, kt),
           jlayers.embed(jc, {"table": tj}, kj))
    got = tlayers.unembed(tc, {"table": tt}, xt)
    assert got.shape[-1] == jc.padded_vocab    # padded rows stay in
    _close(got, jlayers.unembed(jc, {"table": tj}, xj), atol=1e-4, rtol=1e-5)


def test_rope(cfgs):
    jc, tc = cfgs
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, jc.n_heads, jc.hd), np.float32)
    pos = (np.arange(6) + 200).astype(np.int32)
    (xj, xt), (pj, pt) = _both(x), _both(pos)
    sj, cj = jlayers.rope_freqs(jc, pj, jc.hd)
    st, ct = tlayers.rope_freqs(tc, pt, tc.hd)
    _close(st, sj)
    _close(ct, cj)
    _close(tlayers.apply_rope(xt, st, ct), jlayers.apply_rope(xj, sj, cj))


def _pool_case(rng, *, B=2, KV=2, P=9, ps=8, D=24, n=4):
    pool = rng.standard_normal((P, KV, ps, D), np.float32)
    pool[0] = np.nan                       # trash page: read as zeros
    table = rng.integers(1, P, (B, n)).astype(np.int32)
    table[0, -1] = 0
    return pool, table


def test_gather_pages_zeroes_the_trash_page():
    rng = np.random.default_rng(3)
    pool, table = _pool_case(rng)
    (pj, pt), (tj, tt) = _both(pool), _both(table)
    got = tattn.gather_pages(pt, tt)
    assert torch.isfinite(got).all()
    _close(got, jattn.gather_pages(pj, tj), atol=0, rtol=0)


@pytest.mark.parametrize("start", [0, 16])
@pytest.mark.parametrize("window", [None, 5])
def test_chunk_attention_both_branches(start, window):
    """``start == 0``: the first chunk (``_dense_attn``, mask added);
    ``start > 0``: cache + chunk (mask by select)."""
    rng = np.random.default_rng(4)
    B, C, H, KV, D, T = 1, 8, 4, 2, 24, 32
    q = rng.standard_normal((B, C, H, D), np.float32)
    kc = rng.standard_normal((B, KV, T, D), np.float32)
    vc = rng.standard_normal((B, KV, T, D), np.float32)
    kt = rng.standard_normal((B, KV, C, D), np.float32)
    vt = rng.standard_normal((B, KV, C, D), np.float32)
    j = [jnp.asarray(a) for a in (q, kc, vc, kt, vt)]
    t = [torch.from_numpy(a) for a in (q, kc, vc, kt, vt)]
    want = jattn._chunk_attn_with_cache(j[0], j[1], j[2], start, j[3], j[4],
                                        window=window)
    got = tattn._chunk_attn_with_cache(t[0], t[1], t[2], start, t[3], t[4],
                                       window=window)
    _close(got, want)
    if start:
        # the port reads only the cache rows before ``start``; the rest
        # add exact zeros in the reference
        got = tattn._chunk_attn_with_cache(
            t[0], t[1][:, :, :start], t[2][:, :, :start], start, t[3], t[4],
            window=window)
        _close(got, want)


@pytest.mark.parametrize("window", [None, 3])
def test_decode_attention_plus_self(window):
    rng = np.random.default_rng(5)
    B, H, KV, D, T = 3, 4, 2, 24, 20
    q = rng.standard_normal((B, 1, H, D), np.float32)
    kc = rng.standard_normal((B, KV, T, D), np.float32)
    vc = rng.standard_normal((B, KV, T, D), np.float32)
    kt = rng.standard_normal((B, KV, 1, D), np.float32)
    vt = rng.standard_normal((B, KV, 1, D), np.float32)
    lens = np.array([0, 7, 20], np.int32)
    j = [jnp.asarray(a) for a in (q, kc, vc, lens, kt, vt)]
    t = [torch.from_numpy(a) for a in (q, kc, vc, lens, kt, vt)]
    _close(tattn._decode_attn_plus_self(*t, window=window),
           jattn._decode_attn_plus_self(*j, window=window))
