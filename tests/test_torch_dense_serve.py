"""The port's dense serving path against the JAX package's, on the CPU.

The reference's dense-engine tests (``tests/test_serve.py``, the dense and
HyPar-on-dense tests of ``tests/test_serve_scheduler.py``, the dense parts
of ``tests/test_paged_kv.py``, ``tests/test_train_integration.py`` and
``tests/test_prefix_cache.py``) ported to ``repro_torch.serve.Engine``:
each keeps its own assertions, and where it produces logits or token
streams the JAX package runs the same calls first, on the same weights
(carried over by ``weights.from_jax_numpy``), both in fp32.  Logits agree
within 1e-4 of the logit scale (the reference's own 3e-2 where it compares
against ``forward``); streams, outcomes and counters are equal.  Also the
launcher's wave and dense trace modes, and its argument checks word for
word.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.transformer import decode_step as jax_decode_step
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_cache as jax_init_cache
from repro.models.transformer import init_params as jax_init
from repro.serve import Engine as JaxEngine
from repro.serve import HyParRequestTracker as JaxTracker
from repro.serve import ServeScheduler as JaxServeScheduler
from repro.serve import count_generated as jax_count_generated
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (decode_step, init_cache,
                                            param_count, prefill)
from repro_torch.serve import (DEFAULT_BUCKETS, Engine, HyParRequestTracker,
                               PagedEngine, Request, RequestQueue,
                               SamplingParams, ServeScheduler,
                               count_generated)
from repro_torch.weights import from_jax_numpy

ARCHS = ("qwen2-1.5b", "mamba2-370m")
LOGIT_TOL = 1e-4                 # of max|logit|, port vs JAX, fp32
FORWARD_TOL = dict(atol=3e-2, rtol=3e-2)   # the reference's own, vs forward


def _close(got, want, tol=LOGIT_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err} > {tol} x {scale}"


def _carry(jc, tc):
    jp = jax_init(jc, jax.random.PRNGKey(0))
    return jp, from_jax_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")


def _models(arch):
    jc = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    return (jc, tc, *_carry(jc, tc))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's smoke-sized ops: several test
    workers share the CPU, and eight threads each for small kernels spend
    their time waiting on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arch_models():
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = _models(arch)
        return made[arch]
    return get


@pytest.fixture(scope="module")
def qwen(arch_models):
    return arch_models("qwen2-1.5b")


def _ints(seed, shape, vocab):
    return np.random.default_rng(seed).integers(
        0, vocab - 1, shape).astype(np.int32)


def _greedy(logits):
    lg = logits.numpy() if isinstance(logits, torch.Tensor) else \
        np.asarray(logits)
    return np.argmax(lg[:, -1, :], axis=-1).astype(np.int32)


# ---------------------------------------------------------------------------
# tests/test_serve.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [
    *ARCHS, "zamba2-1.2b", "mixtral-8x7b", "qwen2-moe-a2.7b", "gemma3-4b",
])
def test_batched_prefill_then_decode_matches_forward(arch_models, arch):
    """prefill(prompt) + decode(next) must equal forward(prompt+next), and
    each step the JAX package's."""
    jc, tc, jp, tp = arch_models(arch)
    B, S = 2, 17
    toks = _ints(1, (B, S + 1), jc.vocab_size)
    jcache = jax_init_cache(jc, B, S + 8)
    jl_p, jcache = jax_decode_step(jc, jp, jcache, jnp.asarray(toks[:, :S]))
    jl_d, jcache = jax_decode_step(jc, jp, jcache,
                                   jnp.asarray(toks[:, S:S + 1]))
    full, _ = jax_forward(jc, jp, tokens=jnp.asarray(toks))

    cache = init_cache(tc, B, S + 8, device="cpu")
    lp, cache = decode_step(tc, tp, cache, torch.as_tensor(toks[:, :S]))
    ld, cache = decode_step(tc, tp, cache, torch.as_tensor(toks[:, S:S + 1]))
    _close(lp, jl_p)
    _close(ld, jl_d)
    assert int(cache["len"]) == S + 1 and cache["len"].dim() == 0
    np.testing.assert_allclose(lp[:, -1].numpy(), np.asarray(full[:, S - 1]),
                               **FORWARD_TOL)
    np.testing.assert_allclose(ld[:, 0].numpy(), np.asarray(full[:, S]),
                               **FORWARD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_insertion_preserves_other_slots(arch_models, arch):
    jc, tc, jp, tp = arch_models(arch)
    toks = _ints(3, (3, 8), jc.vocab_size)
    new_prompt = _ints(4, (1, 8), jc.vocab_size)
    je = JaxEngine(jc, jp, batch=3, max_len=32, donate_cache=False)
    je.prefill(jnp.asarray(toks))
    want = je.insert(1, jnp.asarray(new_prompt))
    eng = Engine(tc, tp, batch=3, max_len=32, device="cpu")
    eng.prefill(toks)
    before = {k: v.clone() for k, v in eng.cache.items()}
    _close(eng.insert(1, new_prompt), want)
    changed = unchanged = 0
    for key, b in before.items():
        a = eng.cache[key]
        if key == "len":
            assert a.tolist() == [8, 8, 8]
            continue
        # leaves are (layers, B, ...): slot 1 changed, slots 0 and 2 not
        if not torch.equal(b[:, 1], a[:, 1]):
            changed += 1
        assert torch.equal(b[:, 0], a[:, 0])
        assert torch.equal(b[:, 2], a[:, 2])
        unchanged += 1
    assert changed >= 1 and unchanged >= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_insert_compiles_once(arch_models, arch):
    """N inserts of one bucket run the slot prefill at one signature: the
    reference's one compiled program."""
    jc, tc, _, tp = arch_models(arch)
    eng = Engine(tc, tp, batch=3, max_len=48, device="cpu")
    eng.prefill(_ints(1, (3, 8), jc.vocab_size))
    assert eng.trace_count("prefill") == 1        # the (3, 8) signature
    for i in range(4):
        eng.insert(i % 3, _ints(10 + i, (1, 8), jc.vocab_size),
                   true_len=5 + i % 3)
    # 4 inserts -> exactly ONE more prefill signature (1, 8) and ONE
    # splice; slot and true_len are values, not shapes
    assert eng.trace_count("prefill") == 2
    assert eng.trace_count("splice") == 1
    assert eng.trace_count("decode") == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_insert_returns_true_last_token_logits(arch_models, arch):
    """Bucketed (right-padded) prompts sample from the true last prompt
    token, not the pad tail."""
    jc, tc, jp, tp = arch_models(arch)
    batch = _ints(1, (2, 8), jc.vocab_size)
    prompt = _ints(2, (1, 5), jc.vocab_size)
    padded = np.zeros((1, 8), np.int32)
    padded[0, :5] = prompt[0]
    je = JaxEngine(jc, jp, batch=2, max_len=48)
    je.prefill(jnp.asarray(batch))
    want = je.insert(0, jnp.asarray(padded), true_len=5)
    eng = Engine(tc, tp, batch=2, max_len=48, device="cpu")
    eng.prefill(batch)
    lg_padded = eng.insert(0, padded, true_len=5)
    ref = Engine(tc, tp, batch=1, max_len=48, device="cpu")
    lg_ref = ref.prefill(prompt)
    np.testing.assert_allclose(lg_padded.numpy(), lg_ref.numpy(),
                               atol=1e-4, rtol=1e-4)
    _close(lg_padded, want)


def test_insert_splices_enc_out_for_encdec(arch_models):
    """An insert splices the new request's encoder output into its slot's
    row (the others untouched), equal to a standalone encode of it, and
    its logits equal the JAX package's; an insert without enc_embeds
    fails loudly instead of decoding against stale encoder state."""
    jc, tc, jp, tp = arch_models("whisper-base")
    rng = np.random.default_rng(0)
    enc_len = 8
    enc = rng.standard_normal((2, enc_len, tc.d_model), dtype=np.float32)
    toks = _ints(1, (2, 6), tc.vocab_size)
    eng = Engine(tc, tp, batch=2, max_len=32, device="cpu")
    je = JaxEngine(jc, jp, batch=2, max_len=32, donate_cache=False)
    eng.prefill(toks, enc_embeds=enc)
    je.prefill(jnp.asarray(toks), enc_embeds=jnp.asarray(enc))
    enc_before = eng._enc_out.clone()

    new_enc = rng.standard_normal((1, enc_len, tc.d_model), dtype=np.float32)
    new_prompt = _ints(2, (1, 6), tc.vocab_size)
    lg = eng.insert(1, new_prompt, enc_embeds=new_enc)
    _close(lg, je.insert(1, jnp.asarray(new_prompt),
                         enc_embeds=jnp.asarray(new_enc)))
    enc_after = eng._enc_out
    assert torch.equal(enc_after[0], enc_before[0])      # slot 0 untouched
    assert not torch.equal(enc_after[1], enc_before[1])  # slot 1 spliced
    np.testing.assert_allclose(enc_after.numpy(), np.asarray(je._enc_out),
                               atol=1e-5, rtol=1e-5)

    # the spliced row equals a standalone encode of the new input
    ref = Engine(tc, tp, batch=1, max_len=32, device="cpu")
    ref.prefill(new_prompt, enc_embeds=new_enc)
    np.testing.assert_allclose(enc_after[1].numpy(), ref._enc_out[0].numpy(),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="enc_embeds"):
        eng.insert(0, new_prompt)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batching_preserves_surviving_outputs(arch_models, arch):
    """Fill all slots, replace one mid-decode: the surviving slots' tokens
    are bit-identical to an uninterrupted run, and every stream equals the
    JAX package's."""
    jc, tc, jp, tp = arch_models(arch)
    B, S, steps = 3, 8, 8
    prompts = _ints(1, (B, S), jc.vocab_size)
    new_prompt = _ints(9, (1, 8), jc.vocab_size)

    def run(make, insert_at):
        eng = make()
        toks = _greedy(eng.prefill(prompts))
        outs = [toks]
        for i in range(steps):
            if insert_at is not None and i == insert_at:
                lg = eng.insert(1, new_prompt, true_len=5)
                toks = toks.copy()
                toks[1] = _greedy(lg)[0]
            toks = _greedy(eng.decode(toks[:, None]))
            outs.append(toks)
        return np.stack(outs, axis=1)

    def port():
        return Engine(tc, tp, batch=B, max_len=64, device="cpu")

    def ref():
        return JaxEngine(jc, jp, batch=B, max_len=64)

    want = run(ref, 3)
    base = run(port, None)
    mixed = run(port, 3)
    assert np.array_equal(base[0], mixed[0])
    assert np.array_equal(base[2], mixed[2])
    assert not np.array_equal(base[1], mixed[1])
    assert np.array_equal(mixed, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_inserted_request_decodes_at_its_own_position(arch_models, arch):
    """A short prompt inserted into a batch that decoded far ahead yields
    the tokens of a standalone run: its own ``len`` drives positions,
    masking and writes."""
    jc, tc, jp, tp = arch_models(arch)
    B = 3
    prompts = _ints(1, (B, 12), jc.vocab_size)
    short = _ints(2, (1, 5), jc.vocab_size)

    def inserted(eng):
        toks = _greedy(eng.prefill(prompts))
        for _ in range(6):
            toks = _greedy(eng.decode(toks[:, None]))
        toks = toks.copy()
        toks[0] = _greedy(eng.insert(0, short))[0]
        got = [int(toks[0])]
        for _ in range(5):
            toks = _greedy(eng.decode(toks[:, None]))
            got.append(int(toks[0]))
        return got

    jax_got = inserted(JaxEngine(jc, jp, batch=B, max_len=64))
    got = inserted(Engine(tc, tp, batch=B, max_len=64, device="cpu"))
    ref = Engine(tc, tp, batch=B, max_len=64, device="cpu")
    rt = _greedy(ref.prefill(np.tile(short, (B, 1))))
    want = [int(rt[0])]
    for _ in range(5):
        rt = _greedy(ref.decode(rt[:, None]))
        want.append(int(rt[0]))
    assert got == want
    assert got == jax_got


@pytest.mark.parametrize("arch", ARCHS)
def test_temperature_sampling_draws_valid_tokens(arch_models, arch):
    jc, tc, _, tp = arch_models(arch)
    eng = Engine(tc, tp, batch=2, max_len=32, device="cpu")
    out = eng.generate(_ints(6, (2, 6), jc.vocab_size), max_new=6,
                       sp=SamplingParams(temperature=0.8, top_k=16),
                       generator=torch.Generator().manual_seed(7))
    assert out.shape == (2, 6)
    assert (out >= 0).all() and (out < tc.padded_vocab).all()


def test_count_generated_excludes_stop_padding():
    out = np.array([[5, 7, 2, 2, 2],      # stopped at token 3 (stop id 2)
                    [1, 3, 4, 6, 8]])     # never stopped
    for fn in (count_generated, jax_count_generated):
        assert fn(out, stop_token=2) == 3 + 5
        assert fn(out, stop_token=-1) == 10
        assert fn(np.array([[2, 2, 2]]), stop_token=2) == 1


# ---------------------------------------------------------------------------
# The step-by-step reference prefill, and writes past the cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_stepwise_prefill_matches_batched_and_jax(arch_models, arch):
    from repro.models.transformer import prefill as jax_prefill
    jc, tc, jp, tp = arch_models(arch)
    toks = _ints(5, (2, 9), jc.vocab_size)
    jcache, jlast, _ = jax_prefill(jc, jp, jnp.asarray(toks), max_len=24)
    cache, last, _ = prefill(tc, tp, torch.as_tensor(toks), max_len=24)
    _close(last, jlast)
    assert int(cache["len"]) == 9 == int(jcache["len"])
    eng = Engine(tc, tp, batch=2, max_len=24, device="cpu")
    np.testing.assert_allclose(eng.prefill(toks).numpy(), last.numpy(),
                               atol=1e-4, rtol=1e-4)
    assert param_count(tp) == sum(x.size for x in jax.tree.leaves(jp))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_past_max_len_clamps_the_write(arch_models, arch):
    """A free slot's ``len`` keeps growing with every decode step and
    passes ``max_len``: the write lands at the last position, as the
    reference's ``dynamic_update_slice`` clamps it, instead of raising —
    and the live slot decodes on, equal to the JAX package."""
    jc, tc, jp, tp = arch_models(arch)
    max_len, steps = 8, 8
    je = JaxEngine(jc, jp, batch=2, max_len=max_len, donate_cache=False)
    te = Engine(tc, tp, batch=2, max_len=max_len, device="cpu")
    for eng in (je, te):
        eng.ensure_batch()
    prompt = _ints(11, (1, 3), jc.vocab_size)
    jt = _greedy(je.insert(0, jnp.asarray(prompt)))
    tt = _greedy(te.insert(0, prompt))
    assert jt[0] == tt[0]
    toks = np.array([[tt[0]], [0]], np.int32)     # slot 1 stays free
    for _ in range(steps):
        jl = je.decode(jnp.asarray(toks))
        tl = te.decode(toks)
        _close(tl[:1], np.asarray(jl)[:1])
        toks[0, 0] = _greedy(np.asarray(jl))[0]
    lens = te.cache["len"].tolist()
    assert lens == [3 + steps, steps] == np.asarray(je.cache["len"]).tolist()
    assert lens[0] > max_len
    if "k" in te.cache:
        # the live slot's writes past the end all landed at T - 1
        np.testing.assert_allclose(
            te.cache["k"][:, 0].numpy(),
            np.asarray(je.cache["groups"][0]["self"]["k"])[:, 0],
            atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# tests/test_serve_scheduler.py (dense and HyPar-on-dense)
# ---------------------------------------------------------------------------


def _prompt(rng, cfg, n):
    return rng.integers(0, cfg.vocab_size - 1, (n,)).astype(np.int32)


def test_queue_admission_control():
    q = RequestQueue(max_pending=2)
    reqs = [Request(rid=q.next_rid(), tokens=np.zeros(4, np.int32), max_new=2)
            for _ in range(3)]
    assert q.submit(reqs[0]) and q.submit(reqs[1])
    assert not q.submit(reqs[2])            # shed, not queued
    assert q.n_rejected == 1 and len(q) == 2
    q.push_front(reqs[2])                   # fault requeue bypasses admission
    assert len(q) == 3 and q.pop().rid == reqs[2].rid


def test_scheduler_rejects_unplaceable_requests(qwen):
    _, cfg, _, params = qwen
    eng = Engine(cfg, params, batch=2, max_len=32, device="cpu")
    sched = ServeScheduler(eng, buckets=(8, 16))
    rng = np.random.default_rng(0)
    assert sched.submit(_prompt(rng, cfg, 30), max_new=4) is None   # no bucket
    assert sched.submit(_prompt(rng, cfg, 8), max_new=64) is None   # > max_len
    assert sched.queue.n_rejected == 2
    assert sched.submit(_prompt(rng, cfg, 8), max_new=4) is not None
    assert ServeScheduler(eng).buckets == tuple(
        sorted({min(b, 32) for b in DEFAULT_BUCKETS}))


def test_oversized_bucket_is_clamped_not_dropped(qwen):
    _, cfg, _, params = qwen
    eng = Engine(cfg, params, batch=2, max_len=52, device="cpu")
    sched = ServeScheduler(eng, buckets=(8, 16, 64))
    assert sched.buckets == (8, 16, 52)
    rng = np.random.default_rng(6)
    rid = sched.submit(_prompt(rng, cfg, 40), max_new=4)
    assert rid is not None
    results = sched.run()
    assert [r.rid for r in results] == [rid]
    assert results[0].n_generated == 4


def test_trace_replay_sheds_unplaceable_requests(qwen):
    _, cfg, _, params = qwen
    eng = Engine(cfg, params, batch=2, max_len=24, device="cpu")
    sched = ServeScheduler(eng, buckets=(8,))
    rng = np.random.default_rng(7)
    reqs = [Request(rid=0, tokens=_prompt(rng, cfg, 20), max_new=2),
            Request(rid=1, tokens=_prompt(rng, cfg, 6), max_new=3)]
    results = sched.run(reqs)
    assert [r.rid for r in results] == [1]
    assert sched.queue.n_rejected == 1
    assert sched.outcomes[0].outcome == "shed_queue"


def test_scheduler_drains_mixed_lengths_and_matches_standalone(qwen):
    """Six mixed-length requests over two slots: every request's output
    equals the prompt decoded alone, and the JAX scheduler's streams."""
    jc, cfg, jp, params = qwen
    B, max_new = 2, 5
    rng = np.random.default_rng(1)
    prompts = [_prompt(rng, cfg, n) for n in (5, 8, 3, 11, 7, 4)]
    jsched = JaxServeScheduler(JaxEngine(jc, jp, batch=B, max_len=64),
                               buckets=(8, 16))
    for p in prompts:
        jsched.submit(p, max_new=max_new)
    jres = {r.rid: r.tokens for r in jsched.run()}
    sched = ServeScheduler(Engine(cfg, params, batch=B, max_len=64,
                                  device="cpu"), buckets=(8, 16))
    rids = [sched.submit(p, max_new=max_new) for p in prompts]
    assert all(r is not None for r in rids)
    results = {r.rid: r for r in sched.run()}
    assert sorted(results) == sorted(rids)
    assert sched.occupancy > 0.5
    assert {rid: r.tokens for rid, r in results.items()} == jres
    assert sched.occupancy == jsched.occupancy
    ref = Engine(cfg, params, batch=B, max_len=64, device="cpu")
    for rid, prompt in zip(rids, prompts):
        res = results[rid]
        assert res.n_generated == max_new
        assert res.prompt_len == len(prompt)
        want = ref.generate(np.tile(prompt, (B, 1)), max_new=max_new)[0]
        assert res.tokens == want.tolist(), (
            f"rid {rid} (prompt_len {len(prompt)}) diverged from standalone")


def test_scheduler_timestamps_are_ordered(qwen):
    _, cfg, _, params = qwen
    eng = Engine(cfg, params, batch=2, max_len=48, device="cpu")
    sched = ServeScheduler(eng, buckets=(8,))
    rng = np.random.default_rng(2)
    for _ in range(3):
        sched.submit(_prompt(rng, cfg, 6), max_new=3)
    for r in sched.run():
        assert r.ttft_s >= 0.0
        assert all(l >= 0.0 for l in r.step_latencies_s)
        assert r.token_s == sorted(r.token_s)
        assert r.finish_s >= r.token_s[-1]


def test_hypar_tracker_matches_direct_and_uses_job_model(qwen):
    jc, cfg, jp, params = qwen
    B, max_new = 2, 4
    rng = np.random.default_rng(3)
    prompts = [_prompt(rng, cfg, n) for n in (6, 4, 7, 5)]

    def run(tracker, jax_side=False):
        eng = (JaxEngine(jc, jp, batch=B, max_len=48) if jax_side else
               Engine(cfg, params, batch=B, max_len=48, device="cpu"))
        cls = JaxServeScheduler if jax_side else ServeScheduler
        sched = cls(eng, buckets=(8,), tracker=tracker)
        rids = [sched.submit(p, max_new=max_new) for p in prompts]
        return rids, {r.rid: r.tokens for r in sched.run()}, sched

    _, jhypar, _ = run(JaxTracker(B, strategy="cost", flops_per_token=1e6),
                       jax_side=True)
    _, direct, _ = run(None)
    tracker = HyParRequestTracker(B, strategy="cost", flops_per_token=1e6,
                                  devices=[torch.device("cpu")])
    rids, hypar, sched = run(tracker)
    assert direct == hypar
    assert hypar == jhypar
    assert tracker.graph.n_jobs() == 0
    assert len(tracker.store.records) == len(prompts)
    assert all(rec.data is None for rec in tracker.store.records.values())
    assert all(not rec.sent_back for rec in tracker.store.records.values())
    assert tracker.master._fn_time.get(tracker.DECODE_FN, 0.0) > 0.0


def test_hypar_fault_invalidates_kv_and_recovers(qwen):
    """Killing a slot mid-decode loses its KV; the request restarts from
    its prompt and still completes with the tokens of a standalone run."""
    _, cfg, _, params = qwen
    B = 2
    rng = np.random.default_rng(4)
    tracker = HyParRequestTracker(B, strategy="greedy",
                                  devices=[torch.device("cpu")])
    eng = Engine(cfg, params, batch=B, max_len=48, device="cpu")
    sched = ServeScheduler(eng, buckets=(8,), tracker=tracker)
    prompts = [_prompt(rng, cfg, 6) for _ in range(3)]
    rids = [sched.submit(p, max_new=6) for p in prompts]

    assert sched.step()                     # slots filled, one decode step
    victim_rid = sched.slots[0].request.rid
    old_wid = tracker.slot_to_wid[0]
    assert sched.fail_slot(0) == victim_rid
    assert not tracker.cluster.workers[old_wid].alive
    assert tracker.slot_to_wid[0] != old_wid
    assert tracker.n_recovered == 1

    results = {r.rid: r for r in sched.run()}
    assert sorted(results) == sorted(rids)
    victim_prompt = prompts[rids.index(victim_rid)]
    ref = Engine(cfg, params, batch=B, max_len=48, device="cpu")
    want = ref.generate(np.tile(victim_prompt, (B, 1)), max_new=6)[0]
    assert results[victim_rid].tokens == want.tolist()


# ---------------------------------------------------------------------------
# tests/test_paged_kv.py, tests/test_prefix_cache.py (dense parts)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_scheduler_matches_dense(arch_models, arch):
    """The same mixed-length requests (multi-chunk prefills included)
    through the dense and the paged engine give identical tokens — and
    the JAX dense engine's."""
    jc, cfg, jp, params = arch_models(arch)
    rng = np.random.default_rng(1)
    prompts = [_prompt(rng, cfg, n) for n in (5, 40, 12, 23)]

    def run(engine, cls=ServeScheduler):
        sched = cls(engine, buckets=(8, 16, 32, 64))
        rids = [sched.submit(p, max_new=6) for p in prompts]
        assert all(r is not None for r in rids)
        results = {r.rid: r.tokens for r in sched.run()}
        return [results[r] for r in rids]

    want = run(JaxEngine(jc, jp, batch=2, max_len=64), JaxServeScheduler)
    dense = run(Engine(cfg, params, batch=2, max_len=64, device="cpu"))
    paged = run(PagedEngine(cfg, params, batch=2, max_len=64, page_size=8,
                            prefill_chunk=16, device="cpu"))
    assert dense == paged
    assert dense == want


def test_dense_insert_masks_ssm_padding(arch_models):
    """A bucketed (right-padded) prompt into an SSM engine gives the logits
    of the unpadded prompt: pad tokens decay nothing into the state or the
    conv tail."""
    jc, cfg, jp, params = arch_models("mamba2-370m")
    rng = np.random.default_rng(4)
    prompt = _prompt(rng, cfg, 5)
    batch = np.stack([_prompt(rng, cfg, 8)] * 2)
    padded = np.zeros((1, 8), np.int32)
    padded[0, :5] = prompt

    je = JaxEngine(jc, jp, batch=2, max_len=32)
    je.prefill(jnp.asarray(batch))
    jlg = je.insert(0, jnp.asarray(padded), true_len=5)
    eng = Engine(cfg, params, batch=2, max_len=32, device="cpu")
    eng.prefill(batch)
    lg = eng.insert(0, padded, true_len=5)
    ref = Engine(cfg, params, batch=1, max_len=32, device="cpu")
    want = ref.prefill(prompt[None])
    np.testing.assert_allclose(lg.numpy()[0], want.numpy()[0],
                               atol=1e-4, rtol=1e-4)
    _close(lg, jlg)
    # the spliced conv tail and state are the unpadded prompt's
    for key in ("conv", "state"):
        np.testing.assert_allclose(eng.cache[key][:, 0].numpy(),
                                   ref.cache[key][:, 0].numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_prefix_cache_requires_paged_and_gates_ssm(arch_models):
    _, cfg, _, params = arch_models("qwen2-1.5b")
    dense = Engine(cfg, params, batch=1, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="prefix_cache"):
        ServeScheduler(dense, prefix_cache=True)
    with pytest.raises(ValueError, match="device_groups"):
        ServeScheduler(dense, device_groups=2)
    _, mcfg, _, mparams = arch_models("mamba2-370m")
    meng = PagedEngine(mcfg, mparams, batch=1, max_len=32, page_size=8,
                       prefill_chunk=16, device="cpu")
    assert not meng.supports_prefix_cache
    sched = ServeScheduler(meng, prefix_cache=True)
    assert sched.prefix is None
    assert not sched.prefix_cache_active


# ---------------------------------------------------------------------------
# tests/test_train_integration.py (serving)
# ---------------------------------------------------------------------------


TI = dict(name="ti", family="dense", n_layers=2, d_model=64, n_heads=4,
          n_kv_heads=2, d_ff=128, vocab_size=256, compute_dtype="float32")


@pytest.fixture(scope="module")
def ti():
    jc, tc = JaxModelConfig(**TI), ModelConfig(**TI)
    return (jc, tc, *_carry(jc, tc))


def test_engine_prefill_matches_forward(ti):
    jc, tc, jp, tp = ti
    toks = _ints(4, (2, 12), 255)
    full, _ = jax_forward(jc, jp, tokens=jnp.asarray(toks))
    want = JaxEngine(jc, jp, batch=2, max_len=32).prefill(jnp.asarray(toks))
    pre = Engine(tc, tp, batch=2, max_len=32, device="cpu").prefill(toks)
    np.testing.assert_allclose(pre[:, 0].numpy(), np.asarray(full[:, -1]),
                               atol=1e-4, rtol=1e-4)
    _close(pre, want)


def test_engine_greedy_generation_deterministic(ti):
    jc, tc, jp, tp = ti
    toks = _ints(6, (2, 8), 255)
    want = JaxEngine(jc, jp, batch=2, max_len=64).generate(
        jnp.asarray(toks), max_new=8)
    eng = Engine(tc, tp, batch=2, max_len=64, device="cpu")
    out1 = eng.generate(toks, max_new=8)
    out2 = eng.generate(toks, max_new=8)
    np.testing.assert_array_equal(out1, out2)
    assert out1.shape == (2, 8)
    assert (out1 >= 0).all() and (out1 < tc.padded_vocab).all()
    np.testing.assert_array_equal(out1, want)


def test_engine_generation_matches_stepwise_forward(ti):
    """Greedy engine output == argmax over repeated full forwards."""
    jc, tc, jp, tp = ti
    toks = _ints(8, (1, 6), 255)
    seq = toks.copy()
    for _ in range(4):
        logits, _ = jax_forward(jc, jp, tokens=jnp.asarray(seq))
        nxt = int(np.argmax(np.asarray(logits[0, -1])))
        seq = np.concatenate([seq, [[nxt]]], axis=1)
    gen = Engine(tc, tp, batch=1, max_len=32, device="cpu").generate(
        toks, max_new=4)
    for i in range(4):
        assert int(seq[0, 6 + i]) == int(gen[0, i]), f"mismatch at step {i}"


def test_engine_stop_tokens(ti):
    jc, tc, jp, tp = ti
    from repro.serve import SamplingParams as JaxSamplingParams
    toks = _ints(10, (2, 4), 255)
    je = JaxEngine(jc, jp, batch=2, max_len=32)
    stop = int(je.generate(jnp.asarray(toks), max_new=6)[0, 1])
    jout = je.generate(jnp.asarray(toks), max_new=6,
                       sp=JaxSamplingParams(stop_token=stop))
    eng = Engine(tc, tp, batch=2, max_len=32, device="cpu")
    greedy = eng.generate(toks, max_new=6)
    # force a stop at the second generated token
    assert stop == int(greedy[0, 1])
    out = eng.generate(toks, max_new=6, sp=SamplingParams(stop_token=stop))
    row = out[0].tolist()
    assert stop in row
    after = row[row.index(stop):]
    assert all(t == stop for t in after)
    np.testing.assert_array_equal(out, jout)
    assert count_generated(out, stop) == jax_count_generated(jout, stop)


# ---------------------------------------------------------------------------
# The launcher: wave mode, the dense trace, argument checks
# ---------------------------------------------------------------------------


def test_launcher_wave_mode_prints_the_reference_lines(capsys):
    waves = serve_main(["--smoke", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "12", "--max-new", "5",
                        "--requests", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=qwen2-1.5b-smoke params=")
    assert lines[0].endswith("batch=2 max_len=25")
    assert lines[1].startswith("wave 0 (compile): 10 tokens in ")
    assert [l.split(":")[0] for l in lines[2:5]] == \
        ["wave 0", "wave 1", "wave 2"]
    assert "generated (2, 5) -> 10 real tokens; sample row: [" in lines[3]
    assert lines[5].startswith("throughput: ")
    assert "20 tokens in" in lines[5] and "30 total incl. compile wave" in \
        lines[5]
    assert waves["steady_tokens"] == 20 and len(waves["waves"]) == 3
    assert waves["trace_counts"] == {"prefill": 1, "decode": 1, "splice": 0}


def test_launcher_dense_trace_counts_one_prefill_a_bucket(capsys):
    stats = serve_main(["--smoke", "--device", "cpu", "--trace",
                        "--n-requests", "6", "--prompt-lens", "6", "12",
                        "40", "--max-new", "4"])
    assert not stats["paged"] and stats["outcomes"] == {"completed": 6}
    assert stats["gen_tokens"] == 24
    # buckets 8, 16 and 64: one prefill signature a bucket the warmup saw
    assert stats["trace_counts"] == {"prefill": 3, "decode": 1, "splice": 1}
    out = capsys.readouterr().out
    assert "(dense)" in out and "traces={'prefill': 3" in out
    assert "total_pool_bytes" not in stats


@pytest.mark.parametrize("argv", [
    ["--paged"],                                  # paged needs a trace
    ["--trace", "--reserve", "demand"],           # demand needs paged
    ["--trace", "--prefix-cache"],                # sharing needs paged
    ["--shared-prefix-len", "4"],                 # needs a trace
    ["--ttft-deadline", "1"],                     # deadlines need a trace
    ["--total-deadline", "1"],
    ["--watchdog-budget", "1"],
    ["--max-restarts", "1"],
])
def test_launcher_mode_argument_errors_match_jax(argv, capsys):
    from repro.launch.serve import main as jax_main

    errors = []
    for main in (serve_main, jax_main):
        with pytest.raises(SystemExit) as err:
            main(["--smoke", *argv])
        assert err.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0].split(":", 1)[1] == errors[1].split(":", 1)[1]
