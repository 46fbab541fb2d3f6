"""Device groups of the port's serving scheduler, on the CPU.

First the reference's no-mesh group tests (``tests/test_serve_sharded.py``:
partitioning, validation, cost-model routing with page isolation,
group-local preemption) and its restore across groups
(``tests/test_preempt.py``, with the port's ``JobStore``), run against the
port on ``qwen2-1.5b-smoke`` at fp32 compute with the JAX package's
weights (``init_params(cfg, PRNGKey(0))``) carried over.

Then JAX parity: one composed chaos plan — a group kill, a slow-step
window the watchdog trips on, and allocator pressure — over two device
groups under reserve-on-demand with the prefix cache on, through the JAX
``ServeScheduler`` and the port's under one ``FakeClock`` schedule (the
clock advances one second between steps, so only the injected slowness
reaches the watchdog).  Streams, outcomes, the robustness counters and
each admission wave's group per request must be IDENTICAL, for qwen2 and
mamba2; with a HyPar tracker on the ``cost`` strategy, every wave's
``{rid: slot}`` too.  Under HyPar the JAX package's watchdog eviction
leaves the request's job in the tracker's graph, and its re-admission is
refused as a duplicate job: so the HyPar comparison runs the plan without
its slow window, and a last test shows the port, which fails the slot's
worker on a watchdog eviction, serving the whole plan under HyPar with the
JAX package's direct-mode streams and outcomes.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.fault import ServeChaosInjector as JaxChaos
from repro.models.transformer import init_params as jax_init
from repro.serve import HyParRequestTracker as JaxTracker
from repro.serve import PagedEngine as JaxPagedEngine
from repro.serve import ServeScheduler as JaxServeScheduler
from repro_torch.configs import get_smoke_config
from repro_torch.core import JobStore
from repro_torch.core.fault import ServeChaosInjector
from repro_torch.serve import (HyParRequestTracker, PagedEngine,
                               SamplingParams, ServeScheduler)
from repro_torch.weights import from_jax_numpy

CPU = [torch.device("cpu")]


def _models(arch):
    jc = dataclasses.replace(jax_smoke(arch), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    jp = jax_init(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, from_jax_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")


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
    _, tc, _, tp = arch_models("qwen2-1.5b")
    return tc, tp


def _engine(cfg, params, **kw):
    return PagedEngine(cfg, params, device="cpu", **kw)


def _prompt(rng, cfg, n):
    return rng.integers(0, cfg.vocab_size - 1, (n,)).astype(np.int32)


def _reference_tokens(cfg, params, prompts, max_new):
    """Preemption-free single-request runs: one batch=1 paged engine, one
    request at a time — the bit-match oracle."""
    eng = _engine(cfg, params, batch=1, max_len=64, page_size=8,
                  prefill_chunk=16)
    out = []
    for p in prompts:
        sched = ServeScheduler(eng)
        sched.submit(p, max_new=max_new)
        out.append(sched.run()[0].tokens)
    return out


# ---------------------------------------------------------------------------
# tests/test_serve_sharded.py: device groups, no mesh needed
# ---------------------------------------------------------------------------


def test_device_group_partitioning(qwen):
    cfg, params = qwen
    eng = _engine(cfg, params, batch=5, max_len=64, page_size=8,
                  num_pages=30, prefill_chunk=16)
    sched = ServeScheduler(eng, sp=SamplingParams(), reserve="demand",
                           device_groups=2)
    g0, g1 = sched.groups
    # contiguous, disjoint, covering: slots and the usable page range
    assert g0.slot_ids + g1.slot_ids == tuple(range(5))
    assert g0.page_lo == 1 and g1.page_hi == 30
    assert g0.page_hi == g1.page_lo
    # per-group conservation is the single-allocator invariant
    for g in (g0, g1):
        a = g.allocator
        assert a.n_free == a.num_pages - a.n_reserved
    # the single-allocator accessors refuse to guess a group
    with pytest.raises(RuntimeError, match="groups"):
        sched.allocator
    with pytest.raises(RuntimeError, match="groups"):
        sched.prefix


def test_device_groups_validation(qwen):
    cfg, params = qwen
    eng = _engine(cfg, params, batch=2, max_len=64, page_size=8,
                  num_pages=25, prefill_chunk=16)
    with pytest.raises(ValueError, match="batch slots"):
        ServeScheduler(eng, sp=SamplingParams(), device_groups=3)
    with pytest.raises(ValueError, match=">= 1"):
        ServeScheduler(eng, sp=SamplingParams(), device_groups=0)


def test_routing_balances_groups_and_isolates_pages(qwen):
    cfg, params = qwen
    eng = _engine(cfg, params, batch=4, max_len=64, page_size=8,
                  num_pages=33, prefill_chunk=16)
    sched = ServeScheduler(eng, sp=SamplingParams(), reserve="demand",
                           admit_watermark=1, device_groups=2)
    rng = np.random.default_rng(11)
    for _ in range(8):
        sched.submit(rng.integers(1, 50, 12).astype(np.int32), 6)
    results = sched.run()
    assert len(results) == 8
    # cost-model routing spread work over BOTH groups
    occ = sched.group_occupancy
    assert len(occ) == 2 and all(o > 0.0 for o in occ), occ
    # and nothing crossed a group boundary or leaked
    for g in sched.groups:
        assert g.allocator.n_outstanding == 0
        assert g.allocator.n_free == (g.allocator.num_pages
                                      - g.allocator.n_reserved)


def test_group_local_preemption(qwen):
    # pool small enough that decode appends exhaust a group: preemption
    # must pick a victim from the SAME group and the run still completes
    cfg, params = qwen
    eng = _engine(cfg, params, batch=4, max_len=64, page_size=8,
                  num_pages=15, prefill_chunk=16)
    sched = ServeScheduler(eng, sp=SamplingParams(), reserve="demand",
                           admit_watermark=1, device_groups=2)
    rng = np.random.default_rng(5)
    for _ in range(6):
        sched.submit(rng.integers(1, 50, 10).astype(np.int32), 12)
    results = sched.run()
    assert len(results) == 6
    for g in sched.groups:
        assert g.allocator.n_outstanding == 0


# ---------------------------------------------------------------------------
# tests/test_preempt.py: master restart across device groups
# ---------------------------------------------------------------------------


def test_restore_suspended_across_device_groups(qwen, tmp_path):
    """Master restart with ``device_groups=2``: the suspended record
    restores, and with the request's ORIGINAL group quarantined on the
    restarted master the resume re-places onto the healthy group — page
    ownership never crosses a group boundary, KV recomputes from the new
    group's pool, and the output still bit-matches."""
    cfg, params = qwen
    rng = np.random.default_rng(31)
    prompt = _prompt(rng, cfg, 11)
    [ref] = _reference_tokens(cfg, params, [prompt], max_new=8)

    def make(store_path):
        jobstore = JobStore(store_path)
        tracker = HyParRequestTracker(4, jobstore=jobstore, devices=CPU)
        eng = _engine(cfg, params, batch=4, max_len=64, page_size=8,
                      prefill_chunk=16)
        return jobstore, ServeScheduler(eng, reserve="demand",
                                        tracker=tracker, device_groups=2)

    path = tmp_path / "serve.sqlite"
    store_a, sched_a = make(path)
    rid_a = sched_a.submit(prompt, max_new=8)
    for _ in range(4):
        assert sched_a.step()
    st = next(s for s in sched_a.slots if s.request is not None)
    gid_a = sched_a._slot_group[st.slot].gid
    n_retained = len(st.tokens)
    assert n_retained >= 2
    assert sched_a.fail_slot(st.slot) == rid_a
    store_a.close()                            # "master dies" here

    store_b, sched_b = make(path)
    try:
        assert sched_b.restore_suspended() == 1
        sched_b.fail_group(gid_a, reason="device lost across restart")
        rid_b = sched_b.submit(prompt, max_new=8)
        assert rid_b == rid_a                  # rids reproduce from zero
        results = sched_b.run()
        assert [r.rid for r in results] == [rid_b]
        assert results[0].tokens == ref
        assert sched_b.outcomes[rid_b].outcome == "completed"
        assert sched_b.resume_tokens_recomputed >= \
            len(prompt) + n_retained - 1
        # it ran (and only ran) on the surviving group's slots and pages
        assert sched_b.groups[1 - gid_a].occupied_slot_steps > 0
        assert sched_b.groups[gid_a].occupied_slot_steps == 0
        for g in sched_b.groups:
            assert g.allocator.n_outstanding == 0
    finally:
        store_b.close()


# ---------------------------------------------------------------------------
# JAX parity: one composed chaos plan through both schedulers
# ---------------------------------------------------------------------------


ENGINE = dict(batch=4, max_len=64, page_size=8, prefill_chunk=16)
CHAOS = dict(kill_group=(1, 4, 6), slow=(14, 6, 100.0), slow_gid=0,
             pressure=(0, 2, 4, 2))
# the plan HyPar placement is compared under: no watchdog evictions
HYPAR_CHAOS = dict(kill_group=(1, 4, 6), pressure=(0, 2, 4, 2))
SCHED = dict(device_groups=2, reserve="demand", prefix_cache=True,
             watchdog_budget_s=50.0, unhealthy_after=2,
             probe_interval_steps=3, max_restarts=2)
TRACE = [(0, 6), (1, 8), (2, 6), (3, 8), (0, 8), (2, 8), (1, 6), (3, 6)]


class FakeClock:
    """Manually advanced scheduler clock."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _chaos_prompts(cfg):
    """The chaos tests' prompts (5, 11, 19 and 30 tokens), every one longer
    than the shared prefix opening with it: cache hits come from it."""
    rng = np.random.default_rng(7)
    prompts = [_prompt(rng, cfg, n) for n in (5, 11, 19, 30)]
    prefix = _prompt(rng, cfg, 2 * ENGINE["page_size"])
    return [np.concatenate([prefix, p[len(prefix):]])
            if len(p) > len(prefix) else p for p in prompts]


def _chaos_drain(sched, chaos, clock, tracker=None):
    """Submit the trace, step to the end (the clock one second on after
    every step), then idle steps until every group is healthy.  Returns
    what the two packages must agree on."""
    group_waves: dict[int, dict[int, int]] = {}
    start = sched._start_prefill

    def recording_start(req, slot, *args):
        group_waves.setdefault(sched.step_calls, {})[req.rid] = \
            sched._slot_group[slot].gid
        return start(req, slot, *args)

    sched._start_prefill = recording_start
    slot_waves = []
    if tracker is not None:
        place_batch = tracker.place_batch

        def recording(reqs, free_slots, **kw):
            assign = place_batch(reqs, free_slots, **kw)
            slot_waves.append(dict(assign))
            return assign

        tracker.place_batch = recording
    prompts = _chaos_prompts(sched.engine.cfg)
    for idx, max_new in TRACE:
        assert sched.submit(prompts[idx], max_new=max_new) is not None
    steps = 0
    while sched.step() or len(sched.queue):
        clock.t += 1.0
        steps += 1
        assert steps < 500, "drain did not finish"
    while not all(g.healthy for g in sched.groups):
        sched.step()
        clock.t += 1.0
        steps += 1
        assert steps < 600, "groups did not recover"
    chaos.release_pages(sched)
    sched.flush_prefix_cache()
    leaks = [g.allocator.n_outstanding for g in sched.groups]
    return {
        "streams": {r.rid: r.tokens for r in sched.results},
        "outcomes": {rid: (o.outcome, o.detail)
                     for rid, o in sched.outcomes.items()},
        "counters": dict(
            watchdog_trips=sched.watchdog_trips,
            n_group_failovers=sched.n_group_failovers,
            n_group_rejoins=sched.n_group_rejoins,
            n_failed=sched.n_failed, n_preempted=sched.n_preempted,
            rejoin_backoff_s=sched.rejoin_backoff_s,
            n_prefix_lookups=sched.n_prefix_lookups,
            n_prefix_hits=sched.n_prefix_hits,
            resume_tokens_recomputed=sched.resume_tokens_recomputed,
            step_calls=sched.step_calls, n_steps=sched.n_steps,
            n_kills=chaos.n_kills, n_slow_steps=chaos.n_slow_steps,
            n_pressure_pages=chaos.n_pressure_pages),
        "group_waves": group_waves,
        "slot_waves": slot_waves,
        "leaks": leaks,
    }


def _run(side, models, engine, chaos_kw):
    """One drain of the trace under ``chaos_kw`` by the JAX package
    (``side="jax"``) or the port."""
    jc, tc, jp, tp = models
    clock = FakeClock()
    if side == "jax":
        eng = JaxPagedEngine(jc, jp, attn_impl="ref", **ENGINE)
        chaos = JaxChaos(**chaos_kw)
        tracker = (JaxTracker(ENGINE["batch"], strategy="cost",
                              flops_per_token=1e6, devices=jax.devices()[:1])
                   if engine == "hypar" else None)
        sched = JaxServeScheduler(eng, chaos=chaos, clock=clock,
                                  tracker=tracker, **SCHED)
    else:
        eng = PagedEngine(tc, tp, device="cpu", **ENGINE)
        chaos = ServeChaosInjector(**chaos_kw)
        tracker = (HyParRequestTracker(ENGINE["batch"], strategy="cost",
                                       flops_per_token=1e6, devices=CPU)
                   if engine == "hypar" else None)
        sched = ServeScheduler(eng, chaos=chaos, clock=clock,
                               tracker=tracker, **SCHED)
    out = _chaos_drain(sched, chaos, clock, tracker)
    if tracker is not None:
        out["graph_jobs"] = tracker.graph.n_jobs()
    return out


@pytest.mark.parametrize("engine", ["direct", "hypar"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m"])
def test_composed_chaos_matches_jax(arch_models, arch, engine):
    chaos_kw = CHAOS if engine == "direct" else HYPAR_CHAOS
    want = _run("jax", arch_models(arch), engine, chaos_kw)
    got = _run("port", arch_models(arch), engine, chaos_kw)
    assert got == want
    c = got["counters"]
    # the plan really ran every path it names
    assert c["n_kills"] == 1 and c["n_pressure_pages"] > 0
    assert c["n_group_failovers"] >= 1 and c["n_group_rejoins"] >= 1
    assert c["resume_tokens_recomputed"] > 0
    if engine == "direct":
        assert c["watchdog_trips"] >= 1 and c["n_slow_steps"] >= 1
    assert len(got["outcomes"]) == len(TRACE)
    assert set(got["group_waves"][min(got["group_waves"])].values()) == {0, 1}
    assert got["leaks"] == [0, 0]
    if arch == "qwen2-1.5b":
        assert c["n_prefix_lookups"] > 0
    if engine == "hypar":
        assert got["graph_jobs"] == 0
        assert sum(len(w) for w in got["slot_waves"]) == sum(
            len(w) for w in got["group_waves"].values())


def test_hypar_watchdog_eviction_fails_the_worker(arch_models):
    """The whole plan under HyPar placement: the JAX package's re-admission
    of a watchdog-evicted request is refused as a duplicate job; the
    port's completes, with the JAX package's direct-mode streams, outcomes
    and counters, and drains the tracker's graph."""
    from repro.core.job import GraphValidationError

    models = arch_models("qwen2-1.5b")
    with pytest.raises(GraphValidationError, match="duplicate job name"):
        _run("jax", models, "hypar", CHAOS)
    want = _run("jax", models, "direct", CHAOS)
    got = _run("port", models, "hypar", CHAOS)
    assert got["counters"]["watchdog_trips"] >= 1
    assert got["graph_jobs"] == 0 and got["leaks"] == [0, 0]
    for key in ("streams", "outcomes", "counters", "group_waves"):
        assert got[key] == want[key], key
