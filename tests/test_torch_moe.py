"""The port's mixture-of-experts block and MoE models against the JAX
package's, on the CPU.

``apply_moe`` runs on the same weights (the JAX ``init_moe``, carried over
as numpy) and the same inputs (numpy seeds) in both packages, fp32: the
output and the Switch aux loss agree within 1e-5, dropless (S <= 64), with
capacity drops (S > 64, capacity factor 1.0), and with qwen2-moe's shared
experts under a nonzero gate.  The reference's own MoE tests
(``tests/test_substrate.py``) run against the port, and its size tests
(``tests/test_arch_smoke.py``) on the port's configs, counted on the
``meta`` device.

For qwen2-moe-a2.7b and mixtral-8x7b at their smoke configs (JAX weights
carried over by ``weights.from_jax_numpy``, fp32 compute): the forward,
the dense engine's prefill and decode, and the paged engine's chunked
prefill and decode agree within 1e-4 of the logit scale — with 32-token
chunks, and with 128-token chunks whose padded last chunk drops tokens
(the capacity follows the padded length).  A 6-request ``ServeScheduler``
trace gives both packages' greedy streams and outcomes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.moe import apply_moe as jax_apply_moe
from repro.models.moe import init_moe as jax_init_moe
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init
from repro.serve import Engine as JaxEngine
from repro.serve import PagedEngine as JaxPagedEngine
from repro.serve import ServeScheduler as JaxServeScheduler
import repro_torch.models.transformer as ttransformer
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cast_weights
from repro_torch.models.moe import _route, apply_moe, init_moe, moe_capacity
from repro_torch.models.transformer import (check_supported, check_trainable,
                                            forward, init_params, loss_fn,
                                            param_count)
from repro_torch.serve import Engine, PagedEngine, ServeScheduler, chunk_plan
from repro_torch.weights import from_jax_numpy

MOE_ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x7b")
MOE_TOL = dict(atol=1e-5, rtol=1e-5)      # apply_moe, port vs JAX, fp32
LOGIT_TOL = 1e-4                          # of max|logit|, port vs JAX


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's smoke-sized ops (several test
    workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=LOGIT_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err} > {tol} x {scale}"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# apply_moe against the JAX package's
# ---------------------------------------------------------------------------


def _moe_cfgs(**kw):
    fields = dict(name="m", family="moe", n_layers=1, d_model=32,
                  n_heads=2, n_kv_heads=2, d_ff=48, vocab_size=64,
                  n_experts=6, top_k=2, moe_d_ff=40, capacity_factor=1.25,
                  compute_dtype="float32")
    fields.update(kw)
    return JaxModelConfig(**fields), ModelConfig(**fields)


#: name -> (config fields, B, S, capacity factor passed to apply_moe)
MOE_CASES = {
    "dropless": (dict(), 2, 48, None),
    "dropless_at_64": (dict(n_experts=4, top_k=2), 1, 64, 0.5),
    "capacity_drops": (dict(n_experts=4, top_k=2), 2, 96, 1.0),
    "shared_experts": (dict(n_shared_experts=2), 2, 80, None),
    "top1_drops": (dict(n_experts=8, top_k=1), 1, 128, 1.0),
}


def _moe_case(name, seed=0):
    fields, B, S, cf = MOE_CASES[name]
    jc, tc = _moe_cfgs(**fields)
    jp = jax_init_moe(jax.random.PRNGKey(seed), jc)
    if "shared_gate" in jp:
        # a nonzero gate (init is zero: sigmoid 0.5 everywhere)
        jp = dict(jp, shared_gate=jax.random.normal(
            jax.random.PRNGKey(seed + 7), jp["shared_gate"].shape) * 0.5)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    return jc, tc, jp, from_tree(jp), x, cf


def from_tree(jp):
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t))
    return conv(jp)


def _drops(tc, tp, x, cf):
    """(token, choice) pairs the port's router drops on x."""
    C = moe_capacity(tc, x.shape[1], cf)
    *_, keep = _route(tc, tp, torch.as_tensor(x), C)
    return int((~keep).sum())


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_apply_moe_matches_jax(name):
    jc, tc, jp, tp, x, cf = _moe_case(name)
    want, want_aux = jax_apply_moe(jc, jp, jnp.asarray(x), capacity_factor=cf)
    got, aux = apply_moe(tc, tp, torch.as_tensor(x), capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **MOE_TOL)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    n_drop = _drops(tc, tp, x, cf)
    if name.startswith("dropless"):
        assert moe_capacity(tc, x.shape[1], cf) == x.shape[1]
        assert n_drop == 0
    if name.endswith("drops"):
        assert n_drop > 0
        # a dropped pair's combine weight is 0: unbounded capacity differs
        free, _ = apply_moe(tc, tp, torch.as_tensor(x), capacity_factor=1e3)
        assert not torch.allclose(free, got, atol=1e-6)


def test_moe_shared_expert_gate_matches_jax():
    """qwen2-moe's shared experts: the sigmoid gate (computed in fp32)
    scales the dense shared MLP before it joins the routed output."""
    jc, tc, jp, tp, x, cf = _moe_case("shared_experts", seed=3)
    routed = {k: v for k, v in jp.items() if k not in ("shared",
                                                       "shared_gate")}
    want = np.asarray(jax_apply_moe(jc, jp, jnp.asarray(x))[0]) - np.asarray(
        jax_apply_moe(jc, routed, jnp.asarray(x))[0])
    got = apply_moe(tc, tp, torch.as_tensor(x))[0] - apply_moe(
        tc, from_tree(routed), torch.as_tensor(x))[0]
    np.testing.assert_allclose(got.numpy(), want, **MOE_TOL)
    assert float(np.abs(want).max()) > 0.1


def test_moe_capacity_rule():
    """C = ceil(K·S/E·cf), dropless at S <= 64, never above S."""
    _, tc = _moe_cfgs(n_experts=60, top_k=4)
    assert moe_capacity(tc, 256) == 22          # qwen2-moe's 256-token chunk
    assert moe_capacity(tc, 64) == 64 and moe_capacity(tc, 1) == 1
    assert moe_capacity(tc, 1024) == 86
    _, tc = _moe_cfgs(n_experts=2, top_k=2)
    assert moe_capacity(tc, 100, 10.0) == 100


# ---------------------------------------------------------------------------
# the reference's MoE tests (tests/test_substrate.py), against the port
# ---------------------------------------------------------------------------


def _port_moe_cfg(E=4, k=2, cap=10.0):
    return ModelConfig(name="m", family="moe", n_layers=1, d_model=16,
                       n_heads=2, n_kv_heads=2, d_ff=32, vocab_size=64,
                       n_experts=E, top_k=k, moe_d_ff=24,
                       capacity_factor=cap, compute_dtype="float32")


def test_moe_matches_dense_loop_reference():
    """Gather-dispatch MoE == explicit per-token loop when capacity is
    unbounded."""
    cfg = _port_moe_cfg(cap=100.0)
    p = init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32))
    out, aux = apply_moe(cfg, p, x)

    xt = x.reshape(-1, cfg.d_model).numpy().astype(np.float64)
    logits = xt @ p["router"]["w"].numpy().astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ref = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        top = np.argsort(-probs[t])[: cfg.top_k]
        w = probs[t, top] / probs[t, top].sum()
        for e, wt in zip(top, w):
            g = xt[t] @ p["gate"][e].numpy().astype(np.float64)
            u = xt[t] @ p["up"][e].numpy().astype(np.float64)
            h = (g / (1 + np.exp(-g))) * u          # silu(g) * u
            ref[t] += wt * (h @ p["down"][e].numpy().astype(np.float64))
    np.testing.assert_allclose(out.reshape(-1, cfg.d_model).numpy(), ref,
                               atol=2e-3, rtol=2e-3)
    assert np.isfinite(float(aux))


@given(st.integers(0, 10_000))
@settings(max_examples=10, deadline=None)
def test_moe_capacity_drops_are_bounded(seed):
    cfg = _port_moe_cfg(E=4, k=2, cap=1.0)
    p = init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, 32, cfg.d_model)).astype(np.float32))
    out, _ = apply_moe(cfg, p, x)
    assert torch.isfinite(out).all()
    # capacity 1.0: each expert processes at most ceil(k*T/E) tokens; output
    # magnitude stays bounded even with drops
    assert float(out.abs().max()) < 1e3


# ---------------------------------------------------------------------------
# the reference's size tests (tests/test_arch_smoke.py), on the port's
# configs, with the parameters counted on the meta device
# ---------------------------------------------------------------------------


PUBLISHED = {
    "whisper-base": (0.07e9, 0.11e9),
    "qwen2-1.5b": (1.4e9, 1.7e9),
    "deepseek-coder-33b": (32e9, 35e9),
    "gemma3-4b": (3.5e9, 4.5e9),
    "llama3-405b": (400e9, 412e9),
    "zamba2-1.2b": (1.0e9, 1.4e9),
    "mixtral-8x7b": (45e9, 48e9),
    "qwen2-moe-a2.7b": (13e9, 15e9),
    "chameleon-34b": (33e9, 35.5e9),
    "mamba2-370m": (0.3e9, 0.45e9),
}


def _meta_params(arch):
    return init_params(get_config(arch), torch.Generator(), "meta")


#: configs whose tree the reference's ``n_params`` formula does not count:
#: it takes every MLP to be gated (3·d·ff), and gemma3's and whisper's
#: ``gelu`` MLPs have two matrices; whisper's position tables are left out
FORMULA_MISSES = ("gemma3-4b", "whisper-base")


def test_full_configs_match_published_sizes():
    """Every config's formula size is in its published range; its tree,
    counted on the meta device, holds exactly the JAX package's leaves
    (counted abstractly), and, where the formula covers the tree, lies in
    the range within 1e-3 of the formula."""
    for arch in ARCHS:
        lo, hi = PUBLISHED[arch]
        n = get_config(arch).n_params()
        assert lo <= n <= hi, f"{arch}: {n/1e9:.2f}B outside [{lo/1e9}, " \
                              f"{hi/1e9}]"
        check_supported(get_config(arch))
        counted = param_count(_meta_params(arch))
        shapes = jax.eval_shape(lambda: jax_init(jax_config(arch),
                                                 jax.random.PRNGKey(0)))
        assert counted == sum(x.size for x in jax.tree.leaves(shapes)), arch
        if arch in FORMULA_MISSES:
            continue
        assert lo <= counted <= hi, f"{arch}: {counted/1e9:.2f}B counted"
        assert abs(counted - n) <= 1e-3 * n, (arch, counted, n)


def test_moe_active_params():
    for arch, (lo, hi) in (("mixtral-8x7b", (12e9, 14e9)),
                           ("qwen2-moe-a2.7b", (2.2e9, 3.2e9))):
        cfg = get_config(arch)
        assert lo <= cfg.active_params() <= hi
        params = _meta_params(arch)
        moe = params["layers"][0]["moe"]
        per_expert = sum(moe[k][0].numel() for k in ("gate", "up", "down"))
        idle = (cfg.n_experts - cfg.top_k) * per_expert * cfg.n_layers
        active = param_count(params) - idle
        assert lo <= active <= hi, f"{arch}: {active/1e9:.2f}B active"


# ---------------------------------------------------------------------------
# MoE models: what the port runs and refuses
# ---------------------------------------------------------------------------


def test_moe_and_hybrid_serve_but_do_not_train():
    """Named when training refused these families; they train now.  Every
    config runs and trains, gemma3-4b (head dim 256, the flash backward
    kernel's widest) among them; the MoE loss adds the routers' auxiliary
    loss, with a gradient in the router."""
    for arch in ("qwen2-moe-a2.7b", "mixtral-8x7b", "zamba2-1.2b"):
        cfg = get_config(arch)
        check_supported(cfg)
        check_trainable(cfg)
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 8),
                           generator=torch.Generator().manual_seed(1))
    router = params["layers"][0]["moe"]["router"]["w"].requires_grad_()
    total, m = loss_fn(cfg, params, {"tokens": tokens, "labels": tokens})
    assert float(m["aux"]) > 0
    want = m["loss"] + cfg.router_aux_weight * m["aux"]
    torch.testing.assert_close(total.detach(), want.detach())
    (g,) = torch.autograd.grad(total, router)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    for arch in ARCHS:
        check_supported(get_config(arch))
        check_trainable(get_config(arch))


def test_engine_casts_expert_weights_once_and_keeps_the_router():
    """The engine's copy holds the experts in the compute dtype (the
    reference casts them on every call) and the router and shared-expert
    gate in fp32, which the reference reads."""
    cfg = get_smoke_config("qwen2-moe-a2.7b")           # bf16 compute
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = PagedEngine(cfg, params, batch=1, max_len=16, page_size=8,
                      prefill_chunk=8, device="cpu")
    moe = eng.params["layers"][0]["moe"]
    for key in ("gate", "up", "down"):
        assert moe[key].dtype == torch.bfloat16
        assert torch.equal(moe[key], params["layers"][0]["moe"][key].to(
            torch.bfloat16))
    assert moe["shared"]["gate"]["w"].dtype == torch.bfloat16
    assert moe["router"]["w"].dtype == torch.float32
    assert moe["shared_gate"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "zamba2-1.2b"])
def test_init_params_cast_equals_the_engines_cast(arch):
    """``init_params(cast=True)`` (the serve launcher's draw) gives, leaf
    by leaf, the values and dtypes of the engine's cast of the fp32 draw
    from the same seed: experts in bf16, router, gates, norms and SSM
    parameters left in fp32."""
    cfg = get_smoke_config(arch)                        # bf16 compute
    want = cast_weights(init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu"), torch.bfloat16)
    got = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                      cast=True)
    a, b = _flat(got), _flat(want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert {t.dtype for t in a.values()} == {torch.bfloat16, torch.float32}
    if arch == "qwen2-moe-a2.7b":
        assert got["layers"][0]["moe"]["router"]["w"].dtype == torch.float32


def test_port_init_matches_reference_layout():
    """``init_params`` (torch.Generator) draws the tree ``from_jax_numpy``
    produces for both MoE archs: same keys, shapes and dtypes."""
    mine = {}
    for arch in MOE_ARCHS:
        jc, tc, jp, tp = _models(arch)
        mine[arch] = init_params(tc, torch.Generator().manual_seed(0), "cpu")
        a, b = _flat(mine[arch]), _flat(tp)
        assert a.keys() == b.keys()
        for k in a:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
    # qwen2-moe's shared-expert gate starts at zero, as the reference's
    moe = mine["qwen2-moe-a2.7b"]["layers"][0]["moe"]
    assert not moe["shared_gate"].any()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


# ---------------------------------------------------------------------------
# MoE models: the serving steps against the JAX package's
# ---------------------------------------------------------------------------


_MADE = {}


def _models(arch):
    if arch not in _MADE:
        jc = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
        tc = dataclasses.replace(get_smoke_config(arch),
                                 compute_dtype="float32")
        jp = jax_init(jc, jax.random.PRNGKey(0))
        _MADE[arch] = (jc, tc, jp, from_jax_numpy(_np_tree(jp), tc, "cpu"))
    return _MADE[arch]


def _ints(seed, shape, vocab):
    return np.random.default_rng(seed).integers(
        0, vocab - 1, shape).astype(np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_jax(arch):
    jc, tc, jp, tp = _models(arch)
    toks = _ints(1, (2, 40), jc.vocab_size)
    want, want_aux = jax_forward(jc, jp, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, aux = forward(tc, tp, tokens=torch.as_tensor(toks))
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), **MOE_TOL)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dense_engine_matches_jax(arch):
    """The dense engine: a batched prefill (right-padded rows route their
    padding too), an insert and decode steps."""
    jc, tc, jp, tp = _models(arch)
    batch = _ints(2, (2, 9), jc.vocab_size)
    jd = JaxEngine(jc, jp, batch=2, max_len=40)
    td = Engine(tc, tp, batch=2, max_len=40, device="cpu")
    _close(td.prefill(batch), jd.prefill(jnp.asarray(batch)))
    padded = np.zeros((1, 16), np.int32)
    padded[0, :11] = _ints(3, (11,), jc.vocab_size)
    _close(td.insert(1, padded, true_len=11),
           jd.insert(1, jnp.asarray(padded), true_len=11))
    for _ in range(3):
        _close(td.decode(batch[:, :1]), jd.decode(jnp.asarray(batch[:, :1])))


def _paged_steps(arch, chunk, lens, *, steps=4, current=None):
    """Both packages' paged engines on one trace: every chunk of every
    prompt (logits compared), the slots committed, slot 2 freed, then
    ``steps`` decode steps.  ``current["chunk"]`` holds (bucket, valid)
    while the port runs a chunk.  Returns the chunk plans."""
    jc, tc, jp, tp = _models(arch)
    kw = dict(batch=3, max_len=max(lens) + 128, page_size=8,
              prefill_chunk=chunk)
    je = JaxPagedEngine(jc, jp, attn_impl="ref", **kw)
    te = PagedEngine(tc, tp, device="cpu", **kw)
    current = {} if current is None else current
    rng = np.random.default_rng(11)
    toks = np.zeros((3, 1), np.int32)
    plans = []
    nxt = 1
    for slot, n in enumerate(lens):
        prompt = rng.integers(0, jc.vocab_size - 1, (n,)).astype(np.int32)
        need = te.pages_needed(n, steps + 1)
        ids = list(range(nxt, nxt + need))
        nxt += need
        plan = chunk_plan(n, chunk, te.chunk_buckets)
        plans.append(plan)
        for start, blen, valid in plan:
            ck = np.zeros((1, blen), np.int32)
            ck[0, :valid] = prompt[start:start + valid]
            lj = je.prefill_chunk(slot, jnp.asarray(ck), ids, start, valid)
            current["chunk"] = (blen, valid)
            lt = te.prefill_chunk(slot, ck, ids, start, valid)
            current["chunk"] = None
            _close(lt, lj)
        je.commit_slot(slot, ids)
        te.commit_slot(slot, ids)
        toks[slot, 0] = int(np.argmax(np.asarray(lj)[0, -1]))
    je.free_slot(2)
    te.free_slot(2)
    toks[2, 0] = 0
    for _ in range(steps):
        lj = np.asarray(je.decode(jnp.asarray(toks)))
        lt = te.decode(toks)
        _close(lt[:2], lj[:2])
        toks[:2, 0] = np.argmax(lj[:2, -1], axis=-1)
    return plans


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_paged_steps_match_jax(arch):
    """Pages of 8, 32-token chunks: a multi-chunk prompt with a padded last
    bucket, a one-chunk prompt, and a prompt freed before decoding."""
    plans = _paged_steps(arch, 32, (70, 21, 40))
    assert [len(p) for p in plans] == [3, 1, 2]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_padded_chunk_drops_tokens_and_matches_jax(arch, monkeypatch):
    """128-token chunks: the second chunk of a 228-token prompt holds 100
    tokens and 28 of padding, and routes all 128 — its capacity is the
    padded length's, and the router drops pairs there, on both sides
    alike.  Chunks of 64 or fewer tokens are dropless."""
    drops = {}
    current = {}
    moe = ttransformer.apply_moe

    def counting(cfg, p, x, **kw):
        *_, keep = _route(cfg, p, x, moe_capacity(cfg, x.shape[1]))
        key = current.get("chunk")
        drops[key] = drops.get(key, 0) + int((~keep).sum())
        return moe(cfg, p, x, **kw)

    monkeypatch.setattr(ttransformer, "apply_moe", counting)
    plans = _paged_steps(arch, 128, (228, 50, 150), current=current)
    assert plans[0] == [(0, 128, 128), (128, 128, 100)]
    assert plans[1] == [(0, 64, 50)]
    assert drops[128, 100] > 0
    assert drops[64, 50] == 0 and drops[None] == 0     # decode: S = 1


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b"])
def test_moe_scheduler_streams_match_jax(arch):
    """A 6-request trace through each package's ``ServeScheduler`` over
    its paged engine: identical greedy streams and outcomes."""
    jc, tc, jp, tp = _models(arch)
    kw = dict(batch=3, max_len=64, page_size=8, prefill_chunk=16)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jc.vocab_size - 1, (n,)).astype(np.int32)
               for n in (5, 40, 12, 23, 33, 9)]

    def drain(sched):
        for p in prompts:
            assert sched.submit(p, max_new=8) is not None
        tokens = {r.rid: r.tokens for r in sched.run()}
        return tokens, {rid: o.outcome for rid, o in sched.outcomes.items()}

    want = drain(JaxServeScheduler(JaxPagedEngine(jc, jp, attn_impl="ref",
                                                  **kw)))
    got = drain(ServeScheduler(PagedEngine(tc, tp, device="cpu", **kw)))
    assert got == want
    assert len(got[0]) == len(prompts)
    assert set(got[1].values()) == {"completed"}
