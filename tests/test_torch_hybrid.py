"""zamba2's hybrid stack in the port against the JAX package's, on the CPU.

zamba2-1.2b's smoke config (JAX weights carried over by
``weights.from_jax_numpy``, fp32 compute) has the layer plan
``(ssm, ssm, shared) x 2 + (ssm,)``: Mamba-2 blocks with one attention +
MLP block, one parameter set, run at every ``shared`` position.  The
carried weights land in the port's flat layer order; every invocation of
the shared block gets its own K/V (dense buffer or page pool); the
forward, the dense engine's prefill and decode, and the paged engine's
chunked prefill and decode agree within 1e-4 of the logit scale — with
32-token chunks and with 128-token chunks and a padded last chunk — and
the K/V pools the same as the reference's per-group stacks; and a
6-request ``ServeScheduler`` trace gives both packages' greedy streams and
outcomes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init
from repro.serve import Engine as JaxEngine
from repro.serve import PagedEngine as JaxPagedEngine
from repro.serve import ServeScheduler as JaxServeScheduler
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.transformer import (forward, init_cache,
                                            init_paged_cache, init_params,
                                            layer_kinds, layer_plan)
from repro_torch.serve import Engine, PagedEngine, ServeScheduler, chunk_plan
from repro_torch.weights import from_jax_numpy

ARCH = "zamba2-1.2b"
LOGIT_TOL = 1e-4                 # of max|logit|, port vs JAX, fp32
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's smoke-sized ops (several test
    workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="float32")
    jp = jax_init(jc, jax.random.PRNGKey(0))
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _close(got, want, tol=LOGIT_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err} > {tol} x {scale}"


def _ints(seed, shape, vocab):
    return np.random.default_rng(seed).integers(
        0, vocab - 1, shape).astype(np.int32)


def test_hybrid_layer_plan_and_caches():
    """38 SSM blocks and 6 shared invocations at full width: 44 layers,
    each shared invocation an attention layer with its own K/V."""
    cfg = get_config(ARCH)
    kinds = layer_kinds(cfg)
    assert len(kinds) == 44 and kinds.count("ssm") == 38
    assert kinds.count("shared") == 6
    assert kinds[:7] == ("ssm",) * 6 + ("shared",)
    assert kinds[-3:] == ("shared", "ssm", "ssm")
    smoke = get_smoke_config(ARCH)
    dense = init_cache(smoke, 2, 16, device="meta")
    paged = init_paged_cache(smoke, 2, num_pages=9, page_size=8,
                             device="meta")
    n_attn = layer_kinds(smoke).count("shared")
    assert dense["k"].shape == (n_attn, 2, smoke.n_kv_heads, 16, smoke.hd)
    assert paged["v"].shape == (n_attn, 9, smoke.n_kv_heads, 8, smoke.hd)
    assert paged["state"].shape[0] == smoke.n_layers


def test_hybrid_weights_land_in_the_port_layer_order(models):
    """``pattern * n_groups + tail``: group g of pattern position i is
    layer g * len(pattern) + i, the tail follows, shared positions hold
    ``{}``, and the shared block comes across whole."""
    jc, tc, jp, tp = models
    plan = layer_plan(tc)
    assert plan.pattern == ("ssm", "ssm", "shared") and plan.n_groups == 2
    assert plan.tail == ("ssm",)
    kinds = layer_kinds(tc)
    assert len(tp["layers"]) == len(kinds) == 7
    for g in range(plan.n_groups):
        for i, kind in enumerate(plan.pattern):
            layer = tp["layers"][g * len(plan.pattern) + i]
            if kind == "shared":
                assert layer == {} and jp["groups"][i] == {}
                continue
            for key in ("in_proj", "out_proj"):
                np.testing.assert_array_equal(
                    layer["mixer"][key]["w"].numpy(),
                    np.asarray(jp["groups"][i]["mixer"][key]["w"][g]))
            np.testing.assert_array_equal(
                layer["mixer"]["A_log"].numpy(),
                np.asarray(jp["groups"][i]["mixer"]["A_log"][g]))
    np.testing.assert_array_equal(
        tp["layers"][-1]["mixer"]["conv_w"].numpy(),
        np.asarray(jp["tail"][0]["mixer"]["conv_w"]))
    for key in ("q", "k", "v", "o"):
        np.testing.assert_array_equal(
            tp["shared"]["attn"][key]["w"].numpy(),
            np.asarray(jp["shared"]["attn"][key]["w"]))
    np.testing.assert_array_equal(tp["shared"]["mlp"]["down"]["w"].numpy(),
                                  np.asarray(jp["shared"]["mlp"]["down"]["w"]))
    # the port's own init draws the same structure
    mine = init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert [set(l) for l in mine["layers"]] == [set(l) for l in tp["layers"]]
    assert {k: v.shape for k, v in mine["shared"]["attn"]["q"].items()} == \
        {k: v.shape for k, v in tp["shared"]["attn"]["q"].items()}


def test_hybrid_forward_matches_jax(models):
    jc, tc, jp, tp = models
    toks = _ints(1, (2, 40), jc.vocab_size)
    want, want_aux = jax_forward(jc, jp, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, aux = forward(tc, tp, tokens=torch.as_tensor(toks))
    _close(got, want)
    assert float(aux) == float(want_aux) == 0.0


def test_hybrid_dense_engine_matches_jax(models):
    """The dense engine: a batched prefill, an insert of a right-padded
    prompt and decode steps; the shared block's K/V buffers equal the
    reference's per-group stack."""
    jc, tc, jp, tp = models
    batch = _ints(2, (2, 9), jc.vocab_size)
    jd = JaxEngine(jc, jp, batch=2, max_len=40, donate_cache=False)
    td = Engine(tc, tp, batch=2, max_len=40, device="cpu")
    _close(td.prefill(batch), jd.prefill(jnp.asarray(batch)))
    padded = np.zeros((1, 16), np.int32)
    padded[0, :11] = _ints(3, (11,), jc.vocab_size)
    _close(td.insert(1, padded, true_len=11),
           jd.insert(1, jnp.asarray(padded), true_len=11))
    for _ in range(3):
        _close(td.decode(batch[:, :1]), jd.decode(jnp.asarray(batch[:, :1])))
    shared_pos = layer_plan(tc).pattern.index("shared")
    for kk in ("k", "v"):
        np.testing.assert_allclose(
            td.cache[kk].numpy(),
            np.asarray(jd.cache["groups"][shared_pos]["self"][kk]), **TOL)


def _paged_steps(models, chunk, lens, *, steps=4):
    """Both packages' paged engines on one trace: every chunk of every
    prompt (logits compared), the slots committed, slot 2 freed, then
    ``steps`` decode steps; then each shared invocation's K/V pool
    against the reference's stack for that group.  Returns the plans."""
    jc, tc, jp, tp = models
    kw = dict(batch=3, max_len=max(lens) + 128, page_size=8,
              prefill_chunk=chunk)
    je = JaxPagedEngine(jc, jp, attn_impl="ref", **kw)
    te = PagedEngine(tc, tp, device="cpu", **kw)
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
            lt = te.prefill_chunk(slot, ck, ids, start, valid)
            _close(lt, lj)
        je.commit_slot(slot, ids)
        te.commit_slot(slot, ids)
        toks[slot, 0] = int(np.argmax(np.asarray(lj)[0, -1]))
    je.free_slot(2)
    te.free_slot(2)
    toks[2, 0] = 0
    for _ in range(steps):
        lj = np.asarray(je.decode(jnp.asarray(toks),
                                  live_mask=np.array([True, True, False])))
        lt = te.decode(toks, live_mask=np.array([True, True, False]))
        _close(lt[:2], lj[:2])
        toks[:2, 0] = np.argmax(lj[:2, -1], axis=-1)
    shared_pos = layer_plan(tc).pattern.index("shared")
    for kk in ("k", "v"):
        want = np.asarray(je.cache["groups"][shared_pos]["self"][kk])
        # every real page (not the trash page 0)
        np.testing.assert_allclose(getattr(te.rows[0].shards[0], kk)[:, 1:]
                                   .numpy(),
                                   want[:, 1:], **TOL)
    return plans


def test_hybrid_paged_steps_match_jax(models):
    """Pages of 8, 32-token chunks: a multi-chunk prompt with a padded last
    bucket, a one-chunk prompt, and a prompt freed before decoding."""
    plans = _paged_steps(models, 32, (70, 21, 40))
    assert [len(p) for p in plans] == [3, 1, 2]


def test_hybrid_padded_128_chunk_matches_jax(models):
    """128-token chunks (8 SSD chunks of 16 each): a full chunk, then a
    padded one (100 tokens and 28 of padding, masked out of the SSM state
    and written into the slot's own pages)."""
    plans = _paged_steps(models, 128, (228, 50, 150))
    assert plans[0] == [(0, 128, 128), (128, 128, 100)]


def test_hybrid_scheduler_streams_match_jax(models):
    """A 6-request trace through each package's ``ServeScheduler`` over
    its paged engine (decode steps interleaved with chunks under the live
    mask): identical greedy streams and outcomes."""
    jc, tc, jp, tp = models
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
