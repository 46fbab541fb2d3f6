"""gemma3's local/global attention in the port against the JAX package, on
the CPU.

``gemma3-4b-smoke`` (6 layers: (local, local, global) twice, a local
window of 16, head dim 16, qk-norm, tanh gelu, a scaled and tied
embedding) at fp32 compute with the JAX weights carried over by
``weights.from_jax_numpy``: the forward, the dense engine's batched
prefill, insert and decode, and the paged engine's chunked prefill
(pages of 8, 16-token chunks, so every later chunk and every decode step
reaches past the window) and decode agree within 1e-4 of the logit scale;
6-request ``ServeScheduler`` traces over either engine, and the launcher
in ``--trace --paged`` mode, give both packages the same greedy streams
and outcomes.  The full config's plan and windows follow the reference's
(29 local layers of window 1,024, 5 global).  The flash forward's plain
version at gemma3's head dim 256 matches the JAX package's oracle and its
Pallas kernel in interpret mode, causal and windowed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init
from repro.serve import Engine as JaxEngine
from repro.serve import PagedEngine as JaxPagedEngine
from repro.serve import ServeScheduler as JaxServeScheduler
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention.ops import launch_shape
from repro_torch.kernels.tuning import DEFAULT_CANDIDATES
from repro_torch.models.transformer import (_window_for, forward,
                                            layer_kinds)
from repro_torch.serve import Engine, PagedEngine, ServeScheduler, chunk_plan
from repro_torch.weights import from_jax_numpy

ARCH = "gemma3-4b"
LOGIT_TOL = 1e-4                 # of max|logit|, port vs JAX, fp32


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
    return jc, tc, jp, from_jax_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")


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


# B, S, H, KV, causal, window at D 256: gemma3's GQA (G 2), causal, and
# under a window that the sequence passes twice
FA_WIDE_CASES = [(1, 128, 4, 2, True, None), (2, 128, 4, 2, True, 48)]
FA_TOL = {"float32": 2e-6, "bfloat16": 2e-2}   # the reference's own


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_WIDE_CASES)
def test_flash_plain_at_head_dim_256_matches_jax(case, dtype):
    """The flash forward's plain version (the wrapper's CPU path) at
    D 256 against the JAX package's oracle and interpreted kernel."""
    B, S, H, KV, causal, window = case
    rng = np.random.default_rng(50)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, S, H, 256), (B, S, KV, 256),
                             (B, S, KV, 256)))
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    ref = jax_flash(jq, jk, jv, causal=causal, window=window, impl="ref")
    ker = jax_flash(jq, jk, jv, causal=causal, window=window,
                    impl="interpret", q_block=64, kv_block=64)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal,
                                     window=window)
    assert out.dtype == tq.dtype and lse.shape == (B, H, S)
    tol = FA_TOL[dtype]
    for want in (ref, ker):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    wrapped = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert torch.equal(wrapped, out)


def test_flash_launch_shapes_at_head_dim_256():
    """At D 256 the kernel's tiles are 64 keys: of the tuner's grid, the
    128-key shapes are refused on either path (the tuner skips them), the
    others take the plain version's values on the CPU; the default is 128
    rows (64 at D 128 and below)."""
    rng = np.random.default_rng(51)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, 2, 256)).astype(
        np.float32)) for _ in range(3))
    assert launch_shape(q) == (128, 64)
    assert launch_shape(q[..., :128]) == (64, 64)
    want, _ = flash_attention_plain(q, k, v, causal=True)
    for cfg in DEFAULT_CANDIDATES["flash_attention"]:
        if cfg["kv_block"] == 128:
            with pytest.raises(ValueError, match="kv_block 128"):
                flash_attention(q, k, v, causal=True, **cfg)
        else:
            assert torch.equal(flash_attention(q, k, v, causal=True, **cfg),
                               want)


def test_gemma3_plan_and_windows():
    """34 layers: (local x 5, global) x 5 and a tail of 4 local; local
    layers see a window of 1,024, global ones the whole context."""
    cfg = get_config(ARCH)
    kinds = layer_kinds(cfg)
    assert kinds == (("local",) * 5 + ("global",)) * 5 + ("local",) * 4
    assert kinds.count("local") == 29 and kinds.count("global") == 5
    assert _window_for(cfg, "local") == 1024
    assert _window_for(cfg, "global") is None
    assert cfg.hd == 256


@pytest.mark.parametrize("S", [12, 40])
def test_gemma3_forward_matches_jax(models, S):
    """A sequence inside the window, and one 2.5 windows long."""
    jc, tc, jp, tp = models
    toks = _ints(1, (2, S), jc.vocab_size)
    want, _ = jax_forward(jc, jp, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, aux = forward(tc, tp, tokens=torch.as_tensor(toks))
    _close(got, want)
    assert float(aux) == 0.0


def test_gemma3_dense_engine_matches_jax(models):
    """The dense engine: a batched prefill of 30 tokens (past the window),
    an insert of a padded 21-token prompt and decode steps."""
    jc, tc, jp, tp = models
    batch = _ints(2, (2, 30), jc.vocab_size)
    jd = JaxEngine(jc, jp, batch=2, max_len=64)
    td = Engine(tc, tp, batch=2, max_len=64, device="cpu")
    _close(td.prefill(batch), jd.prefill(jnp.asarray(batch)))
    padded = np.zeros((1, 32), np.int32)
    padded[0, :21] = _ints(3, (21,), jc.vocab_size)
    _close(td.insert(1, padded, true_len=21),
           jd.insert(1, jnp.asarray(padded), true_len=21))
    toks = batch[:, :1]
    for _ in range(4):
        lj = jd.decode(jnp.asarray(toks))
        _close(td.decode(toks), lj)
        toks = np.argmax(np.asarray(lj)[:, -1], axis=-1)[:, None].astype(
            np.int32)


def test_gemma3_paged_steps_match_jax(models):
    """Pages of 8, 16-token chunks: a 70-token prompt in five chunks (the
    last one padded), a one-chunk prompt and one freed before decoding;
    the chunk logits and six decode steps match."""
    jc, tc, jp, tp = models
    lens, steps = (70, 13, 40), 6
    kw = dict(batch=3, max_len=max(lens) + 32, page_size=8,
              prefill_chunk=16)
    je = JaxPagedEngine(jc, jp, attn_impl="ref", **kw)
    te = PagedEngine(tc, tp, device="cpu", **kw)
    rng = np.random.default_rng(11)
    toks = np.zeros((3, 1), np.int32)
    plans, nxt = [], 1
    for slot, n in enumerate(lens):
        prompt = rng.integers(0, jc.vocab_size - 1, (n,)).astype(np.int32)
        need = te.pages_needed(n, steps + 1)
        ids = list(range(nxt, nxt + need))
        nxt += need
        plan = chunk_plan(n, 16, te.chunk_buckets)
        plans.append(plan)
        for start, blen, valid in plan:
            ck = np.zeros((1, blen), np.int32)
            ck[0, :valid] = prompt[start:start + valid]
            lj = je.prefill_chunk(slot, jnp.asarray(ck), ids, start, valid)
            _close(te.prefill_chunk(slot, ck, ids, start, valid), lj)
        je.commit_slot(slot, ids)
        te.commit_slot(slot, ids)
        toks[slot, 0] = int(np.argmax(np.asarray(lj)[0, -1]))
    assert [len(p) for p in plans] == [5, 1, 3]
    je.free_slot(2)
    te.free_slot(2)
    toks[2, 0] = 0
    for _ in range(steps):
        lj = np.asarray(je.decode(jnp.asarray(toks)))
        _close(te.decode(toks)[:2], lj[:2])
        toks[:2, 0] = np.argmax(lj[:2, -1], axis=-1)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_gemma3_scheduler_streams_match_jax(models, paged):
    """A 6-request trace (prompts inside and past the window) through each
    package's ``ServeScheduler`` over its paged or dense engine: identical
    greedy streams and outcomes."""
    jc, tc, jp, tp = models
    prompts = [_ints(20 + i, (n,), jc.vocab_size)
               for i, n in enumerate((5, 40, 12, 23, 33, 9))]

    def drain(sched):
        for p in prompts:
            assert sched.submit(p, max_new=8) is not None
        tokens = {r.rid: r.tokens for r in sched.run()}
        return tokens, {rid: o.outcome for rid, o in sched.outcomes.items()}

    if paged:
        kw = dict(batch=3, max_len=64, page_size=8, prefill_chunk=16)
        want = drain(JaxServeScheduler(JaxPagedEngine(jc, jp,
                                                      attn_impl="ref", **kw)))
        got = drain(ServeScheduler(PagedEngine(tc, tp, device="cpu", **kw)))
    else:
        want = drain(JaxServeScheduler(JaxEngine(jc, jp, batch=3,
                                                 max_len=64)))
        got = drain(ServeScheduler(Engine(tc, tp, batch=3, max_len=64,
                                          device="cpu")))
    assert got == want
    assert len(got[0]) == len(prompts)
    assert set(got[1].values()) == {"completed"}


def test_gemma3_launcher_trace_paged_matches_jax(models, monkeypatch):
    """``--arch gemma3-4b --smoke --trace --paged`` through both packages'
    launchers, on one fp32 config and the JAX launcher's weights carried
    over: the same trace (prompts past the window), the same greedy
    streams, outcomes, slot occupancy and chunk-bucket signatures."""
    import repro.launch.serve as jax_launcher
    import repro_torch.launch.serve as launcher

    jc, tc, jp, tp = models
    monkeypatch.setattr(jax_launcher, "get_smoke_config", lambda arch: jc)
    monkeypatch.setattr(launcher, "get_smoke_config", lambda arch: tc)
    monkeypatch.setattr(launcher, "init_params",
                        lambda cfg, gen, device, cast=False: tp)
    streams = []
    for mod, pick in ((launcher, lambda snap: snap["results"]),
                      (jax_launcher, lambda snap: snap[1])):
        replay = mod.replay_trace

        def recording(sched, reqs, replay=replay, pick=pick):
            snap = replay(sched, reqs)
            streams.append({r.rid: list(r.tokens) for r in pick(snap)})
            return snap

        monkeypatch.setattr(mod, "replay_trace", recording)
    argv = ["--arch", ARCH, "--smoke", "--trace", "--paged",
            "--prefill-chunk", "16", "--page-size", "8", "--batch", "3",
            "--n-requests", "5", "--prompt-lens", "6", "20", "40",
            "--max-new", "6"]
    got = launcher.main(argv + ["--device", "cpu"])
    want = jax_launcher.main(argv)
    assert len(streams) == 2 and streams[0] == streams[1]
    assert got["outcomes"] == want["outcomes"] == {"completed": 5}
    assert got["gen_tokens"] == want["gen_tokens"] == 30
    assert got["trace_counts"] == want["trace_counts"]
    assert got["occupancy"] == pytest.approx(want["occupancy"])
