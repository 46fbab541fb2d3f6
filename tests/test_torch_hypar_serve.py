"""The port's HyPar request tracker against the JAX package's, on the CPU.

One trace goes through the JAX ``ServeScheduler(PagedEngine,
tracker=HyParRequestTracker(...))`` and through the port's, under
full-lifetime and reserve-on-demand (preempting) reservation, with the
``greedy`` and ``cost`` strategies, on ``qwen2-1.5b-smoke`` at fp32 compute
with the JAX weights carried over.  Token streams and outcomes, the
``{rid: slot}`` of every ``place_batch`` wave, the preemption count, the
empty job graph at the end and the result records must be IDENTICAL.
Then the JAX package's own tracker, ``fail_slot`` and durable-resume tests,
run on the port's paged engine, and the launcher's ``--engine hypar``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models.transformer import init_params as jax_init
from repro.serve import HyParRequestTracker as JaxTracker
from repro.serve import PagedEngine as JaxPagedEngine
from repro.serve import ServeScheduler as JaxServeScheduler
from repro_torch.configs import get_smoke_config
from repro_torch.core import JobStore
from repro_torch.launch.serve import main as serve_main
from repro_torch.serve import (HyParRequestTracker, PagedEngine,
                               ServeScheduler)
from repro_torch.weights import from_jax_numpy

CPU = [torch.device("cpu")]
ENGINE = dict(batch=3, max_len=64, page_size=8, prefill_chunk=16)


@pytest.fixture(scope="module")
def models():
    arch = "qwen2-1.5b"
    jc = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    jp = jax_init(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, from_jax_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")


@pytest.fixture(scope="module")
def engines(models):
    """One engine per side, shared by the traces (a drained scheduler
    leaves every table row on the trash page)."""
    jc, tc, jp, tp = models
    return (JaxPagedEngine(jc, jp, attn_impl="ref", **ENGINE),
            PagedEngine(tc, tp, device="cpu", **ENGINE))


def _prompts(seed, vocab, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab - 1, (n,)).astype(np.int32) for n in lens]


def _engine(models, batch=2):
    _, tc, _, tp = models
    return PagedEngine(tc, tp, device="cpu", **dict(ENGINE, batch=batch))


def _reference_tokens(models, prompts, max_new):
    """Preemption-free single-request runs: one batch=1 paged engine, one
    request at a time — the bit-match oracle of the recovery tests."""
    eng = _engine(models, batch=1)
    out = []
    for p in prompts:
        sched = ServeScheduler(eng)
        sched.submit(p, max_new=max_new)
        out.append(sched.run()[0].tokens)
    return out


RESERVE = {
    "lifetime": dict(sched={}, lens=(5, 40, 12, 23, 33, 9, 17), max_new=8),
    # 10 usable pages for 3 slots of up to 8 pages each: demand admission
    # has to preempt, and the preempted jobs re-place through later waves
    "demand": dict(sched=dict(reserve="demand", pool_pages=1 + 10),
                   lens=(20, 30, 12, 25, 9), max_new=14),
}


@pytest.mark.parametrize("strategy", ["greedy", "cost"])
@pytest.mark.parametrize("reserve", list(RESERVE))
def test_tracker_matches_jax(models, engines, reserve, strategy):
    conf = RESERVE[reserve]
    prompts = _prompts(5, models[0].vocab_size, conf["lens"])

    def drain(sched, tracker):
        waves = []
        place_batch = tracker.place_batch

        def recording(reqs, free_slots, **kw):
            assign = place_batch(reqs, free_slots, **kw)
            waves.append(dict(assign))
            return assign

        tracker.place_batch = recording
        rids = [sched.submit(p, max_new=conf["max_new"]) for p in prompts]
        assert all(r is not None for r in rids)
        tokens = {r.rid: r.tokens for r in sched.run()}
        outcomes = {rid: o.outcome for rid, o in sched.outcomes.items()}
        records = sorted((name, rec.data is None, rec.sent_back)
                         for name, rec in tracker.store.records.items())
        return (tokens, outcomes, waves, sched.n_preempted,
                tracker.n_preempted, tracker.graph.n_jobs(), records)

    jt = JaxTracker(ENGINE["batch"], strategy=strategy, flops_per_token=1e6,
                    devices=jax.devices()[:1])
    tt = HyParRequestTracker(ENGINE["batch"], strategy=strategy,
                             flops_per_token=1e6, devices=CPU)
    want = drain(JaxServeScheduler(engines[0], tracker=jt, **conf["sched"]),
                 jt)
    got = drain(ServeScheduler(engines[1], tracker=tt, **conf["sched"]), tt)
    assert got == want
    tokens, outcomes, waves, n_pre, tr_pre, n_jobs, records = got
    assert len(tokens) == len(prompts)
    assert set(outcomes.values()) == {"completed"}
    assert sum(len(w) for w in waves) == len(prompts) + n_pre
    assert n_jobs == 0 and n_pre == tr_pre
    assert len(records) == len(prompts)
    assert all(gone and not sent for _, gone, sent in records)
    if reserve == "demand":
        assert n_pre > 0
    # placement changes only which slot a request occupies
    direct = ServeScheduler(engines[1], **conf["sched"])
    for p in prompts:
        direct.submit(p, max_new=conf["max_new"])
    assert {r.rid: r.tokens for r in direct.run()} == tokens


def test_tracker_devices_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        HyParRequestTracker(2)


def test_hypar_tracker_matches_direct_and_uses_job_model(models):
    B, max_new = 2, 4
    prompts = _prompts(3, models[0].vocab_size, (6, 4, 7, 5))

    def run(tracker):
        sched = ServeScheduler(_engine(models, B), tracker=tracker)
        rids = [sched.submit(p, max_new=max_new) for p in prompts]
        return rids, {r.rid: r.tokens for r in sched.run()}, sched

    _, direct, _ = run(None)
    tracker = HyParRequestTracker(B, strategy="cost", flops_per_token=1e6,
                                  devices=CPU)
    rids, hypar, sched = run(tracker)
    # placement must not change results, only bookkeeping
    assert direct == hypar
    # every request went through the job model and was retired again
    assert tracker.graph.n_jobs() == 0
    assert len(tracker.store.records) == len(prompts)
    assert all(rec.data is None for rec in tracker.store.records.values())
    # results were retained worker-local (no_send_back), never sent back
    assert all(not rec.sent_back for rec in tracker.store.records.values())
    # decode timings fed the cost model's EWMA
    assert tracker.master._fn_time.get(tracker.DECODE_FN, 0.0) > 0.0


def test_hypar_fault_invalidates_kv_and_recovers(models):
    """Killing a slot mid-decode loses its retained KV; the request restarts
    from its prompt and still completes with the stream of the unfailed
    (direct) run."""
    B = 2
    prompts = _prompts(4, models[0].vocab_size, (6, 6, 6))
    direct = ServeScheduler(_engine(models, B))
    for p in prompts:
        direct.submit(p, max_new=6)
    want = {r.rid: r.tokens for r in direct.run()}

    tracker = HyParRequestTracker(B, strategy="greedy", devices=CPU)
    sched = ServeScheduler(_engine(models, B), tracker=tracker)
    rids = [sched.submit(p, max_new=6) for p in prompts]
    for _ in range(3):                      # prefill, first token, a decode
        assert sched.step()
    victim_rid = sched.slots[0].request.rid
    old_wid = tracker.slot_to_wid[0]
    failed_rid = sched.fail_slot(0)
    assert failed_rid == victim_rid
    # the dead worker released its cluster slot; a replacement took over
    assert not tracker.cluster.workers[old_wid].alive
    assert tracker.slot_to_wid[0] != old_wid
    assert sorted(tracker.wid_to_slot.values()) == list(range(B))
    assert tracker.n_recovered == 1

    results = {r.rid: r for r in sched.run()}
    assert sorted(results) == sorted(rids)  # victim re-ran to completion
    assert {rid: r.tokens for rid, r in results.items()} == want
    assert tracker.graph.n_jobs() == 0


def test_hypar_demand_preempted_jobs_replace_and_gc(models):
    """Preempted dynamic jobs leave the graph and re-place through the next
    place_batch wave; results match direct demand mode and the graph/store
    are fully GC'd at drain."""
    prompts = _prompts(24, models[0].vocab_size, (5, 40, 12, 23, 9, 30))

    def run(tracker):
        sched = ServeScheduler(_engine(models, 3), reserve="demand",
                               pool_pages=1 + 10, tracker=tracker)
        rids = [sched.submit(p, max_new=6) for p in prompts]
        assert all(r is not None for r in rids)
        return sched, {r.rid: r.tokens for r in sched.run()}

    direct_sched, direct = run(None)
    tracker = HyParRequestTracker(3, strategy="greedy", devices=CPU)
    hypar_sched, hypar = run(tracker)
    assert direct == hypar
    assert direct_sched.n_preempted >= 1
    assert tracker.n_preempted == hypar_sched.n_preempted
    assert tracker.graph.n_jobs() == 0            # preempt+retire GC'd all
    assert all(not w.retained for w in tracker.cluster.workers)


def test_fail_slot_under_demand_resumes_with_retained_tokens(models):
    """Worker failure under reserve-on-demand reuses the resume machinery:
    generated tokens live host-side, so recovery recomputes prompt +
    retained tokens instead of regenerating from scratch — the result still
    bit-matches the unfailed run."""
    [prompt] = _prompts(25, models[0].vocab_size, (9,))
    [ref] = _reference_tokens(models, [prompt], max_new=8)

    sched = ServeScheduler(_engine(models), reserve="demand")
    rid = sched.submit(prompt, max_new=8)
    for _ in range(4):                         # prefill + a few tokens
        assert sched.step()
    st = next(s for s in sched.slots if s.request is not None)
    assert len(st.tokens) >= 2
    tokens_before = list(st.tokens)
    n_before = len(tokens_before)
    assert sched.fail_slot(st.slot) == rid
    assert sched._suspended[rid].tokens == tokens_before
    results = sched.run()
    assert [r.rid for r in results] == [rid]
    assert results[0].tokens == ref
    # recovery recomputed (resume path), it did not regenerate: the resume
    # re-prefilled prompt + retained tokens
    assert sched.resume_tokens_recomputed >= len(prompt) + n_before - 1
    assert sched.allocator.n_outstanding == 0
    assert sched.fail_slot(st.slot) is None    # a free slot: nothing to do


def test_fail_slot_mid_resume_prefill_recovers_and_persists(models, tmp_path):
    """The worker dies AGAIN while the resume prefill is still chunking:
    the retained tokens must survive the second failure, the durable store
    must hold them throughout, and the eventual result still bit-matches
    the unfailed run."""
    [prompt] = _prompts(26, models[0].vocab_size, (20,))  # resume: 2 chunks
    [ref] = _reference_tokens(models, [prompt], max_new=8)

    jobstore = JobStore(tmp_path / "serve.sqlite")
    tracker = HyParRequestTracker(2, jobstore=jobstore, devices=CPU)
    sched = ServeScheduler(_engine(models), reserve="demand", tracker=tracker)
    try:
        rid = sched.submit(prompt, max_new=8)
        for _ in range(4):                     # prefill + a few tokens
            assert sched.step()
        st = next(s for s in sched.slots if s.request is not None)
        tokens_before = list(st.tokens)
        assert len(tokens_before) >= 2
        assert sched.fail_slot(st.slot) == rid
        # first failure persisted the retained tokens durably
        assert tracker.restore_suspended()[rid][0] == tokens_before

        # step until the resume prefill is mid-flight, then fail it again
        mid = None
        for _ in range(30):
            mid = next((s for s in sched.slots
                        if s.resume is not None and s.prefilling), None)
            if mid is not None:
                break
            assert sched.step()
        assert mid is not None, "resume never went mid-prefill"
        assert sched.fail_slot(mid.slot) == rid
        # the record moved back intact: a failed resume retry is NOT a new
        # preemption, so the counter stays put
        assert sched._suspended[rid].tokens == tokens_before
        assert sched._suspended[rid].n_preempts == 1
        assert tracker.restore_suspended()[rid][0] == tokens_before

        results = sched.run()
        assert [r.rid for r in results] == [rid]
        assert results[0].tokens == ref
        # two failures → the resume recompute ran (at least) twice
        assert sched.resume_tokens_recomputed >= 2 * (len(prompt)
                                                      + len(tokens_before) - 1)
        assert sched.allocator.n_outstanding == 0
        # retirement dropped the durable record
        assert tracker.restore_suspended() == {}
    finally:
        jobstore.close()


def test_master_restart_restores_suspended_from_store(models, tmp_path):
    """Kill the MASTER while a request sits preempted: a fresh scheduler
    over the same store re-seeds the suspended table, the resubmitted
    request (same rid — submission order reproduces) resumes by recompute
    instead of regenerating, and the output bit-matches."""
    [prompt] = _prompts(27, models[0].vocab_size, (9,))
    [ref] = _reference_tokens(models, [prompt], max_new=8)

    def make(store_path):
        jobstore = JobStore(store_path)
        tracker = HyParRequestTracker(2, jobstore=jobstore, devices=CPU)
        return jobstore, ServeScheduler(_engine(models), reserve="demand",
                                        tracker=tracker)

    path = tmp_path / "serve.sqlite"
    store_a, sched_a = make(path)
    rid_a = sched_a.submit(prompt, max_new=8)
    for _ in range(4):
        assert sched_a.step()
    st = next(s for s in sched_a.slots if s.request is not None)
    n_retained = len(st.tokens)
    assert n_retained >= 2
    assert sched_a.fail_slot(st.slot) == rid_a
    store_a.close()                            # "master dies" here

    store_b, sched_b = make(path)
    try:
        assert sched_b.restore_suspended() == 1
        rid_b = sched_b.submit(prompt, max_new=8)
        assert rid_b == rid_a                  # rids reproduce from zero
        results = sched_b.run()
        assert [r.rid for r in results] == [rid_b]
        assert results[0].tokens == ref
        # the restart resumed: it recomputed prompt + retained tokens
        assert sched_b.resume_tokens_recomputed >= len(prompt) + n_retained - 1
        assert sched_b.tracker.restore_suspended() == {}
    finally:
        store_b.close()


LAUNCH = ["--smoke", "--device", "cpu", "--trace", "--paged",
          "--prefill-chunk", "32",
          "--n-requests", "6", "--prompt-lens", "6", "12", "40",
          "--max-new", "4"]


def test_launcher_hypar_matches_direct(tmp_path, monkeypatch):
    import repro_torch.launch.serve as launcher

    streams = []
    replay = launcher.replay_trace

    def recording(sched, reqs):
        snap = replay(sched, reqs)
        streams.append({r.rid: r.tokens for r in snap["results"]})
        return snap

    monkeypatch.setattr(launcher, "replay_trace", recording)
    direct = serve_main(LAUNCH)
    store = tmp_path / "serve.sqlite"
    hypar = serve_main(LAUNCH + ["--engine", "hypar", "--strategy", "cost",
                                 "--store", str(store), "--store-gc", "0"])
    assert (direct["engine"], hypar["engine"]) == ("direct", "hypar")
    assert hypar["n_requests"] == direct["n_requests"] == 6
    assert hypar["outcomes"] == {"completed": 6}
    assert len(streams) == 2 and streams[0] == streams[1]
    assert store.exists()


@pytest.mark.parametrize("argv", [
    ["--store", "x.sqlite"],                              # needs hypar
    ["--resume"],                                         # needs hypar
    ["--engine", "hypar", "--resume"],                    # needs --store
    ["--engine", "hypar", "--store", "x.sqlite", "--resume"],  # and demand
    ["--store-gc", "10"],                                 # needs --store
    ["--engine", "hypar", "--store-gc-rows", "3"],        # needs --store
])
def test_launcher_store_argument_errors_match_jax(argv, capsys):
    from repro.launch.serve import main as jax_main

    errors = []
    for main in (serve_main, jax_main):
        with pytest.raises(SystemExit) as err:
            main(["--smoke", "--trace", "--paged", *argv])
        assert err.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    # the same refusal, word for word (after the program name)
    assert errors[0].split(":", 1)[1] == errors[1].split(":", 1)[1]
