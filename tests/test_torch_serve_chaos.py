"""The reference's serve-chaos tests (``tests/test_serve_chaos.py``, the
eleven beyond its deadline tests), run against the port.

Ported with their own assertions, oracles and ``FakeClock``, on the CPU at
``qwen2-1.5b-smoke`` with fp32 compute and weights from a seeded
``torch.Generator``: the step watchdog's evict-and-requeue bit-match and
repeated trips into failover, the per-request restart budget, device-group
failover with re-routing and rejoin, quarantine until a probe, the rejoin
backoff of a flapping group and of a dead one, chaos-held allocator
pressure, the composed smoke drain and the hypothesis chaos soak with the
reference's settings.  Faults are injected into measurements and plans
(``ServeChaosInjector``), never slept or raced.

Then the deviations of the port's health probe (``probe_device``): its op
and the error it catches.
"""
import dataclasses
import functools
import os
from collections import Counter

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro_torch.configs import get_smoke_config
from repro_torch.core.fault import ServeChaosInjector
from repro_torch.serve import TERMINAL_OUTCOMES, PagedEngine, ServeScheduler
from repro_torch.weights import init_params

MAX_EXAMPLES = int(os.environ.get("SERVE_CHAOS_EXAMPLES", "6"))
ARCH = "qwen2-1.5b"
BATCH, MAX_LEN, PAGE, CHUNK = 4, 64, 8, 16
MAX_POOL = 1 + BATCH * (MAX_LEN // PAGE)
MIN_POOL = 1 + 6                 # largest request's worst-case resume span
PROMPT_LENS = (5, 11, 19, 30)    # 30 > CHUNK => multi-chunk prefill
STEP_CAP = 1500


class FakeClock:
    """Manually advanced scheduler clock — tests move time by assignment
    instead of sleeping."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's smoke-sized ops: several test
    workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model():
    cfg = dataclasses.replace(get_smoke_config(ARCH),
                              compute_dtype="float32")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


@functools.lru_cache(maxsize=None)
def _prompts(share=False):
    cfg, _ = _model()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size - 1, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    if share:
        prefix = rng.integers(0, cfg.vocab_size - 1,
                              (2 * PAGE,)).astype(np.int32)
        prompts = [np.concatenate([prefix, p[len(prefix):]])
                   if len(p) > len(prefix) else p for p in prompts]
    return tuple(prompts)


@functools.lru_cache(maxsize=None)
def _engine():
    cfg, params = _model()
    return PagedEngine(cfg, params, batch=BATCH, max_len=MAX_LEN,
                       page_size=PAGE, prefill_chunk=CHUNK, device="cpu")


@functools.lru_cache(maxsize=None)
def _ref_engine():
    cfg, params = _model()
    return PagedEngine(cfg, params, batch=1, max_len=MAX_LEN,
                       page_size=PAGE, prefill_chunk=CHUNK, device="cpu")


@functools.lru_cache(maxsize=None)
def _reference(prompt_idx, max_new, share=False):
    """Fault-free, sharing-free single-request oracle."""
    sched = ServeScheduler(_ref_engine())
    sched.submit(_prompts(share)[prompt_idx], max_new=max_new)
    [res] = sched.run()
    return tuple(res.tokens)


def _fresh_engine():
    # shared engine across tests: park every row so a previous failure
    # cannot cascade
    eng = _engine()
    eng.page_table[:] = 0
    eng._pt_device = None
    return eng


def _sched(**kw):
    return ServeScheduler(_fresh_engine(), **kw)


def _drain(sched, chaos=None, check=None):
    steps = 0
    while sched.step() or len(sched.queue):
        if check is not None:
            check(sched, chaos)
        steps += 1
        assert steps < STEP_CAP, "drain did not finish"
    # recovery tail: the last completion may land in the same wave as a
    # watchdog trip, ending the drain with a group still quarantined.
    # Idle step() calls keep the probe clock advancing; every finite chaos
    # plan lifts, so health must return within a bounded number of calls.
    extra = 0
    while not all(g.healthy for g in sched.groups):
        sched.step()
        extra += 1
        assert extra < 100, "groups did not recover after drain"
    return steps


def _assert_no_leaks(sched, chaos=None):
    if chaos is not None:
        chaos.release_pages(sched)
    sched.flush_prefix_cache()
    for g in sched.groups:
        assert g.allocator.n_outstanding == 0, \
            f"group {g.gid} leaked pages"
    assert (sched.engine.page_table == 0).all()
    assert not sched._suspended


def _check_invariants(sched, chaos=None):
    """The soak's structural checks, chaos-aware: pages the injector holds
    for its pressure plan count toward each group's expected outstanding
    set (at refcount 1 — nothing else maps them)."""
    eng = sched.engine
    for g in sched.groups:
        alloc = g.allocator
        assert alloc.n_free + alloc.n_outstanding == \
            alloc.num_pages - alloc.n_reserved
        owned = [p for i in g.slot_ids for p in sched.slots[i].page_ids]
        mapped = Counter(owned)
        cached = g.prefix.pages() if g.prefix is not None else set()
        held = set(chaos.held_pages(g.gid)) if chaos is not None else set()
        for p in set(mapped) | cached | held:
            assert g.page_lo <= p < g.page_hi, \
                f"group {g.gid} references foreign page {p}"
        for i in g.slot_ids:
            s = sched.slots[i]
            assert len(s.page_ids) == len(set(s.page_ids))
        assert 0 not in mapped and 0 not in cached
        assert set(mapped) | cached | held == set(alloc.outstanding)
        for p in alloc.outstanding:
            want = (mapped[p] + (1 if p in cached else 0)
                    + (1 if p in held else 0))
            assert alloc.refcount(p) == want
            assert alloc.writable(p) == (alloc.refcount(p) == 1)
    for s in sched.slots:
        n = len(s.page_ids)
        row = eng.page_table[s.slot]
        if s.request is not None and not s.prefilling:
            assert row[:n].tolist() == s.page_ids
            assert (row[n:] == 0).all()
        else:
            assert (row == 0).all()


def _assert_outcome_coverage(sched, n_submitted):
    """No request left behind: every rid ever created reached exactly one
    typed outcome, and has a result iff that outcome is ``completed``."""
    assert sorted(sched.outcomes) == list(range(n_submitted))
    for o in sched.outcomes.values():
        assert o.outcome in TERMINAL_OUTCOMES
    completed = {rid for rid, o in sched.outcomes.items()
                 if o.outcome == "completed"}
    by_rid = {}
    for res in sched.results:
        assert res.rid not in by_rid        # completed exactly once
        by_rid[res.rid] = res
    assert set(by_rid) == completed
    return by_rid


# -- step watchdog ---------------------------------------------------------

def test_watchdog_trip_requeues_and_output_bitmatches():
    # steps 2..3 report +100s of measured duration — far over the 50s
    # budget that no real CPU step approaches, so exactly the injected
    # window trips.  unhealthy_after is out of reach: this isolates the
    # evict-and-requeue path from failover.
    chaos = ServeChaosInjector(slow=(2, 2, 100.0))
    sched = _sched(reserve="demand", watchdog_budget_s=50.0,
                   unhealthy_after=10 ** 6, chaos=chaos)
    rids = {sched.submit(_prompts()[i], max_new=6): i for i in range(3)}
    _drain(sched, chaos, check=_check_invariants)
    assert sched.watchdog_trips >= 1 and chaos.n_slow_steps >= 1
    assert all(g.healthy for g in sched.groups)
    by_rid = _assert_outcome_coverage(sched, len(rids))
    for rid, idx in rids.items():
        assert tuple(by_rid[rid].tokens) == _reference(idx, 6), \
            f"rid {rid} diverged after watchdog eviction"
    _assert_no_leaks(sched, chaos)


def test_repeated_trips_drive_group_unhealthy():
    chaos = ServeChaosInjector(slow=(1, 30, 100.0))
    sched = _sched(watchdog_budget_s=50.0, unhealthy_after=2,
                   probe_interval_steps=3, chaos=chaos)
    for i in range(3):
        sched.submit(_prompts()[0], max_new=4)
    _drain(sched, chaos)
    assert sched.n_group_failovers >= 1
    # the slow window ends; probes bring every group back
    assert all(g.healthy for g in sched.groups)
    assert sched.n_group_rejoins >= 1
    _assert_outcome_coverage(sched, 3)
    _assert_no_leaks(sched, chaos)


# -- restart budget --------------------------------------------------------

def test_restart_budget_fails_poison_request():
    sched = _sched(max_restarts=0)
    rid = sched.submit(_prompts()[0], max_new=8)
    sched.step()
    slot = next(s.slot for s in sched.slots if s.request is not None)
    assert sched.fail_slot(slot) == rid
    assert sched.outcomes[rid].outcome == "failed"
    assert sched.n_failed == 1
    sched.run()
    assert not sched.results          # terminally failed, never re-queued
    _assert_no_leaks(sched)


def test_restart_budget_survives_within_limit():
    sched = _sched(max_restarts=2, reserve="demand")
    rid = sched.submit(_prompts()[2], max_new=6)
    sched.step()
    slot = next(s.slot for s in sched.slots if s.request is not None)
    sched.fail_slot(slot)
    [res] = sched.run()
    assert sched.outcomes[rid].outcome == "completed"
    assert tuple(res.tokens) == _reference(2, 6)
    _assert_no_leaks(sched)


# -- group failover --------------------------------------------------------

def test_group_failover_reroutes_and_rejoins():
    # group 1 dies at call 3 and stays dead for 6 calls: its in-flight
    # requests re-route to group 0 (placement never crosses a page-range
    # boundary — the request simply re-prefills from the healthy pool) and
    # the group rejoins via the health probe once the fault lifts.
    chaos = ServeChaosInjector(kill_group=(1, 3, 6))
    sched = _sched(device_groups=2, reserve="demand",
                   probe_interval_steps=2, chaos=chaos)
    rids = {}
    for idx, max_new in [(0, 4), (1, 6), (2, 4), (3, 6), (0, 6), (2, 6)]:
        rids[sched.submit(_prompts()[idx], max_new=max_new)] = (idx, max_new)
    _drain(sched, chaos, check=_check_invariants)
    assert chaos.n_kills == 1
    assert sched.n_group_failovers == 1 and sched.n_group_rejoins == 1
    assert all(g.healthy for g in sched.groups)
    by_rid = _assert_outcome_coverage(sched, len(rids))
    for rid, (idx, max_new) in rids.items():
        assert tuple(by_rid[rid].tokens) == _reference(idx, max_new), \
            f"rid {rid} diverged across group failover"
    _assert_no_leaks(sched, chaos)


def test_failed_group_quarantine_holds_until_probe():
    sched = _sched(device_groups=2, probe_interval_steps=10 ** 6)
    sched.fail_group(1, reason="test")
    assert not sched.groups[1].healthy
    # admission only sees group 0's slots while 1 is quarantined
    for _ in range(4):
        sched.submit(_prompts()[0], max_new=2)
    sched.step()
    assert all(sched.slots[s].request is None
               for s in sched.groups[1].slot_ids)
    sched.run()
    assert sched.probe_group(1)       # manual probe rejoins it
    assert sched.groups[1].healthy and sched.n_group_rejoins == 1
    _assert_outcome_coverage(sched, 4)
    _assert_no_leaks(sched)


def test_flaky_group_rejoin_backoff():
    """A group that flaps — rejoins, then fails again shortly after — is
    probed at exponentially growing intervals, capped at
    ``rejoin_backoff_cap``; a long stable stretch forgives the history.
    ``rejoin_backoff_s`` accumulates the (FakeClock) seconds groups spend
    down waiting between probes."""
    clock = FakeClock()
    sched = _sched(device_groups=2, probe_interval_steps=2,
                   rejoin_backoff_cap=8, clock=clock)

    def steps_to_rejoin():
        n = 0
        while not sched.groups[1].healthy:
            clock.t += 1.0
            sched.step()
            n += 1
            assert n < 200, "group never rejoined"
        return n

    # first incident probes at the base cadence (multiplier 1)
    sched.fail_group(1, reason="flap")
    assert sched.groups[1].probe_backoff == 1
    assert steps_to_rejoin() == 2
    # immediate re-failures double the interval: 2 -> 4 -> 8, capped at 8
    for expect in (2, 4, 8, 8):
        sched.fail_group(1, reason="flap")
        assert sched.groups[1].probe_backoff == expect
        assert steps_to_rejoin() == 2 * expect
    # each down stretch waited 1s per step on the FakeClock
    assert sched.rejoin_backoff_s == pytest.approx(2 * (1 + 2 + 4 + 8 + 8))
    # a stable stretch of probe_interval_steps * cap calls resets the
    # multiplier: the next incident is fresh, back at base cadence
    for _ in range(2 * 8):
        sched.step()
    sched.fail_group(1, reason="fresh")
    assert sched.groups[1].probe_backoff == 1
    assert steps_to_rejoin() == 2
    assert sched.n_group_rejoins == 6
    _assert_no_leaks(sched)


def test_dead_group_probes_back_off_exponentially():
    """A group whose probes KEEP failing is probed exponentially less
    often, not at constant cadence."""
    chaos = ServeChaosInjector(kill_group=(1, 2, 50))
    sched = _sched(device_groups=2, probe_interval_steps=2,
                   rejoin_backoff_cap=8, chaos=chaos)
    n = 0
    while not all(g.healthy for g in sched.groups) or sched.step_calls < 3:
        sched.step()
        n += 1
        assert n < 200, "group never rejoined"
    # failed probes at calls 4, 8, 16, 32, 48 double the multiplier to the
    # cap; the fault lifts at call 52 and the NEXT backed-off probe (call
    # 64) rejoins — 6 probe attempts where constant cadence would make 31
    assert sched.step_calls == 64
    assert sched.groups[1].probe_backoff == 8
    assert chaos.n_kills == 1 and sched.n_group_rejoins == 1
    _assert_no_leaks(sched, chaos)


# -- allocator pressure ----------------------------------------------------

def test_chaos_pressure_is_held_then_released_leak_free():
    chaos = ServeChaosInjector(pressure=(0, 1, 4, MAX_POOL))
    sched = _sched(reserve="demand", pool_pages=MIN_POOL + 4, chaos=chaos)
    rids = [sched.submit(_prompts()[i % 3], max_new=4) for i in range(4)]
    _drain(sched, chaos, check=_check_invariants)
    assert chaos.n_pressure_pages > 0
    assert not chaos.held_pages(0)    # window ended -> released in-run
    _assert_outcome_coverage(sched, len(rids))
    _assert_no_leaks(sched, chaos)


# -- composed smoke + the soak ---------------------------------------------

def test_chaos_smoke_composed():
    """The smoke drain: a group kill, a slow-step window and allocator
    pressure staggered through one deterministic trace."""
    chaos = ServeChaosInjector(kill_group=(1, 4, 6),
                               slow=(14, 6, 100.0), slow_gid=0,
                               pressure=(0, 2, 4, 2))
    sched = _sched(device_groups=2, reserve="demand",
                   watchdog_budget_s=50.0, unhealthy_after=2,
                   probe_interval_steps=3, chaos=chaos)
    rids = {}
    for idx, max_new in [(0, 6), (1, 8), (2, 6), (3, 8), (0, 8), (2, 8),
                         (1, 6), (3, 6)]:
        rids[sched.submit(_prompts()[idx], max_new=max_new)] = (idx, max_new)
    _drain(sched, chaos, check=_check_invariants)
    assert chaos.n_kills == 1 and chaos.n_pressure_pages > 0
    assert sched.n_group_failovers >= 1 and sched.n_group_rejoins >= 1
    assert all(g.healthy for g in sched.groups)
    by_rid = _assert_outcome_coverage(sched, len(rids))
    assert all(o.outcome == "completed" for o in sched.outcomes.values())
    for rid, (idx, max_new) in rids.items():
        assert tuple(by_rid[rid].tokens) == _reference(idx, max_new), \
            f"rid {rid} diverged under composed chaos"
    _assert_no_leaks(sched, chaos)


@given(reqs=st.lists(st.tuples(st.integers(0, len(PROMPT_LENS) - 1),
                               st.sampled_from((2, 4, 6, 8))),
                     min_size=3, max_size=7),
       pool=st.integers(MIN_POOL, MAX_POOL),
       demand=st.booleans(),
       share=st.booleans(),
       kill_after=st.sampled_from((None, 1, 2, 4, 6, 8)),
       slow_after=st.sampled_from((None, 1, 2, 4, 6, 8)),
       pressurize=st.booleans(),
       ttft_deadline=st.sampled_from((None, 0.0, 60.0)))
@settings(max_examples=MAX_EXAMPLES, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
def test_chaos_soak(reqs, pool, demand, share, kill_after, slow_after,
                    pressurize, ttft_deadline):
    chaos = ServeChaosInjector(
        kill_group=(1, kill_after, 5) if kill_after is not None else None,
        slow=(slow_after, 4, 100.0) if slow_after is not None else None,
        pressure=(0, 2, 5, 3) if pressurize else None)
    sched = ServeScheduler(
        _fresh_engine(), pool_pages=pool,
        reserve="demand" if demand else "lifetime",
        prefix_cache=share, device_groups=2,
        watchdog_budget_s=50.0, unhealthy_after=2,
        probe_interval_steps=3, chaos=chaos)
    admitted = {}
    n_submitted = 0
    for idx, max_new in reqs:
        rid = sched.submit(_prompts(share)[idx], max_new=max_new,
                           ttft_deadline_s=ttft_deadline)
        n_submitted += 1
        if rid is not None:
            admitted[rid] = (idx, max_new)

    steps = 0
    while sched.step() or len(sched.queue):
        _check_invariants(sched, chaos)
        steps += 1
        assert steps < STEP_CAP, (
            f"drain did not finish (reqs={reqs}, pool={pool}, "
            f"demand={demand}, share={share}, kill={kill_after}, "
            f"slow={slow_after}, pressure={pressurize})")
    # recovery tail (see _drain): idle calls until every probe lands
    extra = 0
    while not all(g.healthy for g in sched.groups):
        sched.step()
        extra += 1
        assert extra < 100, "groups did not recover after drain"

    _check_invariants(sched, chaos)
    by_rid = _assert_outcome_coverage(sched, n_submitted)
    # tokens of everything that completed bit-match the fault-free,
    # sharing-free oracle — kills, trips and pressure are invisible in
    # the output or the request did not complete, never in between
    for rid, res in by_rid.items():
        idx, max_new = admitted[rid]
        assert tuple(res.tokens) == _reference(idx, max_new, share), (
            f"rid {rid} diverged (pool={pool}, demand={demand}, "
            f"share={share}, kill={kill_after}, slow={slow_after})")
    # a finite chaos plan always lifts: every group must be healthy again
    assert all(g.healthy for g in sched.groups)
    _assert_no_leaks(sched, chaos)


# -- the health probe: where the port differs from the reference ------------

def test_probe_device_runs_one_op_and_reads_it_back(monkeypatch):
    """The probe runs one small op on the engine's device and reads the
    result back, as the reference's does (``jnp.sum`` of two ones, there
    jitted): on a healthy device both say True."""
    from repro.serve import PagedEngine as JaxPagedEngine
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models.transformer import init_params as jax_init
    import jax

    eng = _fresh_engine()
    calls = []
    real_ones = torch.ones

    def counting_ones(*args, **kw):
        calls.append(kw.get("device"))
        return real_ones(*args, **kw)

    monkeypatch.setattr(torch, "ones", counting_ones)
    assert eng.probe_device() is True
    monkeypatch.undo()
    assert calls == [eng.device]
    jc = dataclasses.replace(jax_smoke(ARCH), compute_dtype="float32")
    jeng = JaxPagedEngine(jc, jax_init(jc, jax.random.PRNGKey(0)), batch=1,
                          max_len=16, page_size=8, prefill_chunk=8)
    assert jeng.probe_device() is True


def test_probe_device_false_only_on_a_device_error(monkeypatch):
    """A device error (PyTorch raises ``RuntimeError`` for CUDA errors,
    ``torch.AcceleratorError`` among them) makes the probe say False and
    the group stays quarantined with its backoff doubled; any other error
    is a bug and propagates out of ``probe_group``.  (The reference
    catches every ``Exception``.)"""
    from repro_torch.serve import engine as engine_mod

    sched = _sched(device_groups=2, probe_interval_steps=10 ** 6)
    sched.fail_group(1, reason="test")

    def lost(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(engine_mod.torch, "ones", lost)
    assert sched.probe_group(1) is False
    assert not sched.groups[1].healthy
    assert sched.groups[1].probe_backoff == 2

    def bug(*args, **kw):
        raise TypeError("not a device error")

    monkeypatch.setattr(engine_mod.torch, "ones", bug)
    with pytest.raises(TypeError):
        sched.probe_group(1)
    monkeypatch.undo()
    assert sched.probe_group(1) is True
    assert sched.groups[1].healthy and sched.n_group_rejoins == 1
    _assert_no_leaks(sched)


# -- metrics reset and the launcher ------------------------------------------

def test_reset_metrics_clears_the_robustness_counters():
    """A warm-up drain under chaos leaves counters behind; ``reset_metrics``
    clears them (and each group's occupancy and trips) as the reference's
    does, and keeps the groups' step EWMAs — calibration, not metrics."""
    chaos = ServeChaosInjector(kill_group=(1, 2, 2), slow=(1, 2, 100.0),
                               slow_gid=0)
    sched = _sched(device_groups=2, reserve="demand", max_restarts=0,
                   watchdog_budget_s=50.0, unhealthy_after=2,
                   probe_interval_steps=1, chaos=chaos)
    for idx in range(4):
        sched.submit(_prompts()[idx], max_new=4)
    _drain(sched, chaos)
    assert sched.watchdog_trips and sched.n_failed and sched._restarts
    assert sched.n_group_failovers and sched.n_group_rejoins
    ewma = [g.ewma_step_s for g in sched.groups]
    sched.reset_metrics()
    assert (sched.watchdog_trips, sched.n_failed, sched.n_expired,
            sched.n_group_failovers, sched.n_group_rejoins,
            sched.rejoin_backoff_s, sched._restarts, sched.outcomes) == \
        (0, 0, 0, 0, 0, 0.0, {}, {})
    assert all(g.occupied_slot_steps == 0 and g.watchdog_trips == 0
               for g in sched.groups)
    assert sched.group_occupancy == [0.0, 0.0]
    assert [g.ewma_step_s for g in sched.groups] == ewma
    _assert_no_leaks(sched, chaos)


def test_launcher_reports_the_robustness_stats(capsys):
    """``--watchdog-budget`` and ``--max-restarts`` reach the scheduler
    under ``--trace``; the stats carry the reference's robustness keys and
    the ``deadlines:`` line prints them."""
    from repro_torch.launch.serve import main

    stats = main(["--smoke", "--device", "cpu", "--trace", "--paged",
                  "--reserve", "demand", "--watchdog-budget", "5",
                  "--max-restarts", "2", "--prefill-chunk", "32",
                  "--n-requests", "6", "--prompt-lens", "6", "12", "40",
                  "--max-new", "6"])
    for key in ("watchdog_trips", "device_groups", "group_occupancy",
                "outcomes", "n_expired", "n_failed", "group_failovers",
                "group_rejoins", "rejoin_backoff_s", "suspended_rids",
                "shed_queue_full", "shed_never_fits", "shed_deadline",
                "goodput_tokens", "goodput_tok_per_s"):
        assert key in stats, key
    assert stats["outcomes"] == {"completed": 6}
    assert stats["device_groups"] == 1 and stats["n_failed"] == 0
    out = capsys.readouterr().out
    assert "deadlines: enforce=True" in out
    assert "failed=0 watchdog_trips=0 failovers=0" in out
