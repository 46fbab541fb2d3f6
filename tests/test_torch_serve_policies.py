"""The reference's serving-policy tests, run against the port.

Ported with their own assertions and oracles, on the CPU at the smoke
configs (fp32 compute, weights from a seeded ``torch.Generator``):

* reserve-on-demand paging and preemption (``tests/test_preempt.py``, the
  tests without a HyPar tracker or device groups): the allocator
  watermark, page appends, the victim policy and its guards, declared
  budgets, preempt/resume bit-match against preemption-free runs, and the
  resume chunk's logits against the uninterrupted decode;
* prefix caching and copy-on-write (``tests/test_prefix_cache.py``):
  refcounts, validation, the chunk plan's suffix property, the cache's
  chain semantics, hit admission bit-match, forged-sharing COW and the
  insert-on-second-sight gate;
* deadlines (``tests/test_serve_chaos.py``, the three deadline tests):
  TTFT shedding, total-deadline expiry in the queue and mid-flight,
  goodput;
* the hypothesis soak (``tests/test_serve_properties.py``), with the
  reference's settings, over one or two device groups.

Trace-count assertions read the port's shape signatures
(``PagedEngine.trace_count``), the counterpart of the reference's jit
traces.
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
from repro_torch.serve import (PageAllocator, PagedEngine, PrefixCache,
                               ServeScheduler, chunk_buckets_for, chunk_plan)
from repro_torch.serve.scheduler import Request
from repro_torch.weights import init_params


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _paged(arch="qwen2-1.5b", *, batch, max_len=64):
    cfg, params = _model(arch)
    return PagedEngine(cfg, params, batch=batch, max_len=max_len,
                       page_size=8, prefill_chunk=16, device="cpu")


def _prompt(rng, cfg, n):
    return rng.integers(0, cfg.vocab_size - 1, (n,)).astype(np.int32)


def _fresh(eng):
    eng.page_table[:] = 0
    eng._pt_device = None
    return eng


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
def qwen():
    return _model("qwen2-1.5b")


# ---------------------------------------------------------------------------
# tests/test_preempt.py
# ---------------------------------------------------------------------------


def _reference_tokens(arch, prompts, max_new):
    """Preemption-free single-request runs on a batch-1 paged engine —
    the bit-match oracle for every preemption test."""
    eng = _paged(arch, batch=1)
    out = []
    for p in prompts:
        sched = ServeScheduler(eng)
        sched.submit(p, max_new=max_new)
        out.append(sched.run()[0].tokens)
    return out


def test_allocator_watermark_blocks_admissions_not_appends():
    a = PageAllocator(8, watermark=2)       # 7 usable, 2 held back
    assert a.admit(6) is None               # would leave 1 < watermark
    got = a.admit(5)
    assert got is not None and a.n_free == 2
    assert a.admit(1) is None               # admissions stop at watermark
    assert a.alloc(1) is not None           # appends may dip below it
    assert a.n_free == 1


def test_append_page_validation():
    eng = _paged(batch=2, max_len=32)
    eng.ensure_batch()
    with pytest.raises(ValueError):         # trash page is never appendable
        eng.append_page(0, 0)
    with pytest.raises(ValueError):         # uncommitted slot has no prefix
        eng.append_page(0, 3)
    eng.commit_slot(0, [1, 2])
    eng.append_page(0, 3)
    assert eng.page_table[0, :3].tolist() == [1, 2, 3]
    eng.append_page(0, 4)
    with pytest.raises(ValueError):         # table width max_pages=4
        eng.append_page(0, 5)


@pytest.fixture(scope="module")
def demand_sched():
    return ServeScheduler(_paged(batch=4), reserve="demand")


def _fake_slot(sched, slot, *, n_tokens, admit_seq, pages, resume_base=0):
    st = sched.slots[slot]
    st.request = object()                   # host-side only: never decoded
    st.tokens = list(range(n_tokens))
    st.admit_seq = admit_seq
    st.page_ids = list(pages)
    alloc = sched.allocator
    for p in pages:
        if alloc.refcount(p) == 0:
            alloc._free.remove(p)
            alloc._ref[p] = 1
    st.resume_base = resume_base
    st.pending_chunks, st.finished = [], False
    return st


def _clear_slots(sched):
    for st in sched.slots:
        if st.page_ids:
            sched.allocator.free(st.page_ids)
        st.request, st.tokens, st.page_ids = None, [], []
        st.resume_base, st.admit_seq, st.pending_chunks = 0, 0, []


def test_victim_policy_fewest_with_lifo_tiebreak(demand_sched):
    sched = demand_sched
    _clear_slots(sched)
    _fake_slot(sched, 0, n_tokens=5, admit_seq=1, pages=[1])
    _fake_slot(sched, 1, n_tokens=2, admit_seq=2, pages=[2])
    _fake_slot(sched, 2, n_tokens=2, admit_seq=3, pages=[3])
    assert sched._choose_victim(sched.groups[0]).slot == 2
    sched.preempt_policy = "lifo"
    try:
        assert sched._choose_victim(sched.groups[0]).slot == 2
        _fake_slot(sched, 0, n_tokens=5, admit_seq=9, pages=[1])
        assert sched._choose_victim(sched.groups[0]).slot == 0
    finally:
        sched.preempt_policy = "fewest"
        _clear_slots(sched)


def test_anti_thrash_guard_requires_covering_victim(demand_sched):
    sched = demand_sched
    _clear_slots(sched)
    _fake_slot(sched, 0, n_tokens=1, admit_seq=1, pages=[1])        # 1 page
    _fake_slot(sched, 1, n_tokens=8, admit_seq=2, pages=[2, 3, 4])  # 3 pages
    assert sched._choose_victim(sched.groups[0], shortfall=2).slot == 1
    assert sched._choose_victim(sched.groups[0], shortfall=4) is None
    _clear_slots(sched)


def test_resume_progress_floor_protects_resumed_slots(demand_sched):
    sched = demand_sched
    _clear_slots(sched)
    floor = sched.resume_floor
    resumed = _fake_slot(sched, 0, n_tokens=3, admit_seq=2, pages=[1],
                         resume_base=3)
    fresh = _fake_slot(sched, 1, n_tokens=3 + floor, admit_seq=1, pages=[2])
    assert sched._choose_victim(sched.groups[0]) is fresh
    resumed.tokens = list(range(3 + floor))
    assert sched._choose_victim(sched.groups[0]) is resumed
    fresh.request = None
    resumed.tokens = list(range(3))
    assert sched._choose_victim(sched.groups[0]) is None
    _clear_slots(sched)


def test_watermark_rejected_outside_demand_mode():
    eng = _paged(batch=2, max_len=32)
    with pytest.raises(ValueError, match="admit_watermark"):
        ServeScheduler(eng, reserve="lifetime", admit_watermark=3)


def test_declared_budget_drives_admission_not_generation(qwen):
    cfg, _ = qwen
    eng = _paged(batch=2)
    lt = ServeScheduler(eng, reserve="lifetime")
    dm = ServeScheduler(eng, reserve="demand")
    req = Request(rid=0, tokens=np.zeros(5, np.int32), max_new=4,
                  budget_new=40)
    assert req.declared_new == 40
    assert lt._admission_pages(req, lt._prefill_stream(req)) == 6
    assert dm._admission_pages(req, dm._prefill_stream(req)) == 1
    too_big = Request(rid=1, tokens=np.zeros(5, np.int32), max_new=4,
                      budget_new=60)
    assert not lt._fits(too_big) and not dm._fits(too_big)
    assert lt._fits(req) and dm._fits(req)
    rng = np.random.default_rng(26)
    sched = ServeScheduler(eng, reserve="demand")
    sched.submit(_prompt(rng, cfg, 5), max_new=3, budget_new=40)
    [res] = sched.run()
    assert res.n_generated == 3


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m"])
def test_preempt_resume_bitmatch_and_bounded_compiles(arch):
    cfg, _ = _model(arch)
    rng = np.random.default_rng(21)
    prompts = [_prompt(rng, cfg, n) for n in (5, 40, 12, 23, 9, 30)]
    refs = _reference_tokens(arch, prompts, max_new=6)

    eng = _paged(arch, batch=3)
    sched = ServeScheduler(eng, reserve="demand", pool_pages=1 + 10)
    rids = [sched.submit(p, max_new=6) for p in prompts]
    assert all(r is not None for r in rids)
    results = {r.rid: r.tokens for r in sched.run()}

    assert sched.n_preempted >= 1
    assert sched.resume_tokens_recomputed > 0
    assert sorted(results) == sorted(rids)
    assert all(results[rid] == refs[i] for i, rid in enumerate(rids))
    assert sched.allocator.n_outstanding == 0
    assert (eng.page_table == 0).all()
    assert eng.trace_count("chunk_prefill") <= len(eng.chunk_buckets)
    assert eng.trace_count("decode") == 1


def test_demand_admits_where_lifetime_defers(qwen):
    cfg, _ = qwen
    rng = np.random.default_rng(22)
    prompts = [_prompt(rng, cfg, 10) for _ in range(2)]

    def run(reserve):
        sched = ServeScheduler(_paged(batch=2, max_len=32), reserve=reserve,
                               pool_pages=1 + 6)
        for p in prompts:
            assert sched.submit(p, max_new=20) is not None
        return sched, sched.run()

    lt, lt_res = run("lifetime")
    dm, dm_res = run("demand")
    assert len(lt_res) == len(dm_res) == 2
    assert lt.n_admit_deferred > 0
    assert lt.occupancy <= 0.75
    assert dm.occupancy > lt.occupancy
    assert ({r.rid: r.tokens for r in lt_res}
            == {r.rid: r.tokens for r in dm_res})


@pytest.mark.parametrize("arch", ["mamba2-370m", "qwen2-1.5b"])
def test_resume_chunk_logits_match_uninterrupted_decode(arch):
    cfg, _ = _model(arch)
    rng = np.random.default_rng(23)
    prompt = _prompt(rng, cfg, 11)
    g = 5

    eng = _paged(arch, batch=2)
    alloc = PageAllocator(eng.num_pages)
    pages = alloc.alloc(eng.pages_needed(len(prompt), g + 2))
    lg = eng.insert(0, prompt, page_ids=pages, max_new=g + 2)
    toks = [int(torch.argmax(lg[0, -1]))]
    for _ in range(g - 1):
        step = np.array([[toks[-1]], [0]], np.int32)
        lg = eng.decode(step, live_mask=np.array([True, False]))
        toks.append(int(torch.argmax(lg[0, -1, :])))
    want = lg[0].numpy()

    alloc.free(pages)
    eng.free_slot(0)
    stream = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])
    pages = alloc.alloc(eng.pages_needed(len(stream), 1))
    got = None
    for start, blen, vlen in chunk_plan(len(stream), eng.chunk_len,
                                        eng.chunk_buckets):
        ck = np.zeros((1, blen), np.int32)
        ck[0, :vlen] = stream[start:start + vlen]
        got = eng.prefill_chunk(1, ck, pages, start, vlen)
    eng.commit_slot(1, pages)
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5, rtol=1e-5)
    lg = eng.decode(np.array([[0], [toks[-1]]], np.int32),
                    live_mask=np.array([False, True]))
    assert int(torch.argmax(lg[1, -1, :])) == int(np.argmax(want[-1]))


# ---------------------------------------------------------------------------
# tests/test_prefix_cache.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine():
    return _paged(batch=2)


def test_allocator_share_refcount_and_writable():
    a = PageAllocator(8)
    [p, q] = a.alloc(2)
    assert a.refcount(p) == 1 and a.writable(p)
    a.share([p])
    assert a.refcount(p) == 2 and not a.writable(p)
    assert a.writable(q)
    a.free([p])
    assert a.refcount(p) == 1 and a.writable(p)
    assert p in a.outstanding
    a.free([p, q])
    assert a.refcount(p) == 0 and a.n_outstanding == 0
    with pytest.raises(ValueError):
        a.share([p])
    assert a.refcount(3) == 0 and not a.writable(0)


def test_allocator_free_validates_whole_batch_before_mutating():
    a = PageAllocator(8)
    pages = a.alloc(4)
    free_before, out_before = a.n_free, set(a.outstanding)
    with pytest.raises(ValueError):
        a.free([pages[0], pages[1], 99])
    assert a.n_free == free_before
    assert set(a.outstanding) == out_before
    assert all(a.refcount(p) == 1 for p in pages)
    with pytest.raises(ValueError):
        a.free([pages[0], pages[0]])
    assert a.refcount(pages[0]) == 1
    a.share([pages[0]])
    a.free([pages[0], pages[0]])
    assert a.refcount(pages[0]) == 0
    a.free(pages[1:])
    assert a.n_outstanding == 0 and a.n_free == 7


def test_commit_slot_rejects_zero_mid_row_and_overlong(engine):
    eng = _fresh(engine)
    eng.ensure_batch()
    with pytest.raises(ValueError):
        eng.commit_slot(0, [1, 0, 2])
    with pytest.raises(ValueError):
        eng.commit_slot(0, [1, eng.num_pages])
    with pytest.raises(ValueError):
        eng.commit_slot(0, list(range(1, eng.max_pages + 2)))
    assert (eng.page_table[0] == 0).all()
    eng.commit_slot(0, [1, 2])
    assert eng.page_table[0, :2].tolist() == [1, 2]
    eng.free_slot(0)


def test_append_page_bounds_checks_pool_size(engine):
    eng = _fresh(engine)
    eng.ensure_batch()
    eng.commit_slot(0, [1])
    with pytest.raises(ValueError):
        eng.append_page(0, eng.num_pages)
    with pytest.raises(ValueError):
        eng.append_page(0, 0)
    eng.append_page(0, 2)
    assert eng.page_table[0, :2].tolist() == [1, 2]
    eng.free_slot(0)


def test_chunk_plan_start_is_suffix_of_full_plan():
    buckets = chunk_buckets_for(16, 8)
    for true_len in (17, 33, 40, 48, 61):
        full = chunk_plan(true_len, 16, buckets)
        for k in range(1, len(full)):
            start = full[k][0]
            assert chunk_plan(true_len, 16, buckets, start=start) == full[k:]
    with pytest.raises(ValueError):
        chunk_plan(40, 16, buckets, start=8)
    with pytest.raises(ValueError):
        chunk_plan(16, 16, buckets, start=16)


def test_prefix_cache_lookup_insert_chain():
    a = PageAllocator(16)
    pc = PrefixCache(page_size=4)
    toks = np.arange(11, dtype=np.int32)
    pages = a.alloc(3)
    assert pc.insert(toks, pages, a) == 2
    assert all(a.refcount(p) == 2 for p in pages[:2])
    assert a.refcount(pages[2]) == 1
    assert pc.lookup(toks) == pages[:2]
    longer = np.concatenate([toks[:8], np.full(8, 7, np.int32)])
    assert pc.lookup(longer) == pages[:2]
    other = np.concatenate([np.full(4, 9, np.int32), toks[4:]])
    assert pc.lookup(other) == []
    dup = a.alloc(2)
    assert pc.insert(toks[:8], dup, a) == 0
    assert pc.lookup(toks) == pages[:2]
    a.free(dup)
    pc.flush(a)
    a.free(pages)
    assert a.n_outstanding == 0


def test_prefix_cache_eviction_deepest_first_and_refcount_guard():
    a = PageAllocator(8)
    pc = PrefixCache(page_size=4)
    toks = np.arange(12, dtype=np.int32)
    pages = a.alloc(3)
    pc.insert(toks, pages, a)
    a.free(pages)
    assert set(a.outstanding) == set(pages) and len(pc) == 3
    a.share([pages[1]])
    freed = pc.evict_for(a, a.n_free + 3)
    assert freed == 2
    assert set(a.outstanding) == {pages[1]}
    assert len(pc) == 1 and pc.pages() == {pages[1]}
    a.free([pages[1]])
    assert pc.flush(a) == 1
    assert a.n_outstanding == 0 and a.n_free == 7


def test_cache_hit_admission_bitmatches_no_cache_run(qwen):
    cfg, _ = qwen
    eng = _paged(batch=1)
    rng = np.random.default_rng(3)
    prefix = _prompt(rng, cfg, 24)
    prompts = [np.concatenate([prefix, _prompt(rng, cfg, 7)]),
               np.concatenate([prefix, _prompt(rng, cfg, 9)]),
               np.concatenate([prefix, _prompt(rng, cfg, 8)])]

    def run(share):
        sched = ServeScheduler(eng, prefix_cache=share)
        _fresh(eng)
        out = []
        for p in prompts:
            sched.submit(p, max_new=5)
            out.append(sched.run()[-1].tokens)
        if share:
            assert sched.n_prefix_hits >= 2
            assert sched.pages_shared > 0
            cached = sched.prefix.pages()
            assert set(sched.allocator.outstanding) == cached
            sched.flush_prefix_cache()
        assert sched.allocator.n_outstanding == 0
        return out

    assert run(False) == run(True)


def test_forged_shared_page_triggers_cow_on_decode(qwen):
    cfg, _ = qwen
    eng = _paged(batch=1)
    rng = np.random.default_rng(4)
    prompt = _prompt(rng, cfg, 12)

    def run(forge):
        sched = ServeScheduler(eng, reserve="demand")
        _fresh(eng)
        sched.submit(prompt, max_new=10)
        forged = []
        while sched.step():
            st = sched.slots[0]
            if forge and st.request is not None and not st.prefilling \
                    and not forged:
                forged = list(st.page_ids)
                sched.allocator.share(forged)
        [res] = sched.results
        if forge:
            assert sched.n_cow_copies >= 1
            assert set(forged) <= set(sched.allocator.outstanding)
            sched.allocator.free(forged)
        assert sched.allocator.n_outstanding == 0
        return res.tokens

    assert run(False) == run(True)


def test_admit_after_inserts_on_second_sight():
    a = PageAllocator(16)
    pc = PrefixCache(page_size=4, admit_after=2)
    toks = np.arange(8, dtype=np.int32)
    pages = a.alloc(2)
    assert pc.insert(toks, pages, a) == 0
    assert pc.n_insert_deferred == 2 and len(pc) == 0
    assert all(a.refcount(p) == 1 for p in pages)
    assert pc.lookup(toks) == []
    assert pc.insert(toks, pages, a) == 2
    assert all(a.refcount(p) == 2 for p in pages)
    assert pc.lookup(toks) == pages
    assert pc._seen == {}
    pc.flush(a)
    a.free(pages)
    assert a.n_outstanding == 0


def test_admit_after_broken_chain_defers_children():
    a = PageAllocator(16)
    pc = PrefixCache(page_size=4, admit_after=2)
    toks = np.arange(12, dtype=np.int32)
    pages = a.alloc(3)
    pc.insert(toks[:8], pages[:2], a)
    pc.insert(toks, pages, a)
    assert len(pc) == 2
    assert pc.n_insert_deferred == 2 + 1
    pc.insert(toks, pages, a)
    assert len(pc) == 3
    pc.flush(a)
    a.free(pages)
    assert a.n_outstanding == 0


def test_admit_after_flush_clears_sight_counts():
    a = PageAllocator(16)
    pc = PrefixCache(page_size=4, admit_after=2)
    toks = np.arange(4, dtype=np.int32)
    pages = a.alloc(1)
    pc.insert(toks, pages, a)
    assert pc._seen and pc.flush(a) == 0
    assert pc._seen == {}
    pc.insert(toks, pages, a)
    assert len(pc) == 0
    a.free(pages)


def test_admit_after_validation():
    with pytest.raises(ValueError, match="admit_after"):
        PrefixCache(page_size=4, admit_after=0)


def test_scheduler_prefix_admit_gates_first_sight(qwen):
    cfg, _ = qwen
    eng = _paged(batch=1)
    rng = np.random.default_rng(6)
    prefix = _prompt(rng, cfg, 16)
    prompts = [np.concatenate([prefix, _prompt(rng, cfg, 7)])
               for _ in range(3)]
    sched = ServeScheduler(eng, prefix_cache=True, prefix_admit=2)
    _fresh(eng)
    for p in prompts:
        sched.submit(p, max_new=4)
        sched.run()
    assert sched.n_cache_insert_deferred >= 1
    assert sched.n_prefix_hits == 1
    assert sched.pages_shared > 0
    sched.flush_prefix_cache()
    assert sched.allocator.n_outstanding == 0


# ---------------------------------------------------------------------------
# tests/test_serve_chaos.py: deadlines
# ---------------------------------------------------------------------------


class FakeClock:
    """Manually advanced scheduler clock."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@functools.lru_cache(maxsize=None)
def _chaos_prompts():
    cfg, _ = _model("qwen2-1.5b")
    rng = np.random.default_rng(7)
    return tuple(rng.integers(0, cfg.vocab_size - 1, (n,)).astype(np.int32)
                 for n in (5, 11, 19, 30))


@functools.lru_cache(maxsize=None)
def _chaos_engine():
    return _paged(batch=4)


def _chaos_sched(**kw):
    return ServeScheduler(_fresh(_chaos_engine()), **kw)


def _assert_no_leaks(sched):
    sched.flush_prefix_cache()
    for g in sched.groups:
        assert g.allocator.n_outstanding == 0, f"group {g.gid} leaked pages"
    assert (sched.engine.page_table == 0).all()
    assert not sched._suspended


def test_admission_sheds_unmeetable_ttft_deadline():
    clock = FakeClock()
    clock.t = 100.0
    sched = _chaos_sched(clock=clock)
    rid = sched.submit(_chaos_prompts()[0], max_new=4, arrival_s=90.0,
                       ttft_deadline_s=1.0)
    assert rid is None
    assert sched.queue.shed_deadline == 1
    [(_, o)] = sched.outcomes.items()
    assert o.outcome == "shed_deadline"
    sched = _chaos_sched(clock=clock, enforce_deadlines=False)
    rid = sched.submit(_chaos_prompts()[0], max_new=4, arrival_s=90.0,
                       ttft_deadline_s=1.0)
    assert rid is not None
    [res] = sched.run()
    assert sched.outcomes[rid].outcome == "completed"
    assert sched.goodput_tokens == 0
    assert res.n_generated == 4


def test_total_deadline_expires_in_queue_and_mid_flight():
    clock = FakeClock()
    sched = _chaos_sched(clock=clock)
    rid_q = sched.submit(_chaos_prompts()[0], max_new=4, total_deadline_s=5.0)
    clock.t = 10.0
    sched.step()
    assert sched.outcomes[rid_q].outcome == "expired"
    rid_m = sched.submit(_chaos_prompts()[0], max_new=30,
                         total_deadline_s=5.0)
    sched.step()
    assert any(s.request is not None for s in sched.slots)
    clock.t = 20.0
    sched.step()
    assert sched.outcomes[rid_m].outcome == "expired"
    assert all(s.request is None for s in sched.slots)
    assert sched.n_expired == 2 and not sched.results
    _assert_no_leaks(sched)


def test_completed_within_deadlines_counts_toward_goodput():
    sched = _chaos_sched()
    rid = sched.submit(_chaos_prompts()[1], max_new=6, ttft_deadline_s=60.0,
                       total_deadline_s=60.0)
    [res] = sched.run()
    assert sched.outcomes[rid].outcome == "completed"
    assert sched.goodput_tokens == res.n_generated > 0


# ---------------------------------------------------------------------------
# tests/test_serve_properties.py: the soak
# ---------------------------------------------------------------------------


MAX_EXAMPLES = int(os.environ.get("SERVE_SOAK_EXAMPLES", "10"))
SOAK_ARCHS = ("qwen2-1.5b", "mamba2-370m")
BATCH, MAX_LEN, PAGE = 3, 64, 8
MAX_POOL = 1 + BATCH * (MAX_LEN // PAGE)
MIN_POOL = 1 + 5
PROMPT_LENS = (3, 9, 12, 23, 30, 40)
STEP_CAP = 800


@functools.lru_cache(maxsize=None)
def _soak_prompts(arch, share=False):
    cfg, _ = _model(arch)
    rng = np.random.default_rng(99)
    prompts = [rng.integers(0, cfg.vocab_size - 1, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    if share:
        prefix = rng.integers(0, cfg.vocab_size - 1,
                              (2 * PAGE,)).astype(np.int32)
        prompts = [np.concatenate([prefix, p[len(prefix):]])
                   if len(p) > len(prefix) else p for p in prompts]
    return tuple(prompts)


@functools.lru_cache(maxsize=None)
def _soak_engine(arch):
    return _paged(arch, batch=BATCH, max_len=MAX_LEN)


@functools.lru_cache(maxsize=None)
def _soak_reference(arch, prompt_idx, max_new, share=False):
    sched = ServeScheduler(_paged(arch, batch=1, max_len=MAX_LEN))
    sched.submit(_soak_prompts(arch, share)[prompt_idx], max_new=max_new)
    [res] = sched.run()
    return tuple(res.tokens)


def _check_invariants(sched):
    eng = sched.engine
    for g in sched.groups:
        alloc = g.allocator
        assert alloc.n_free + alloc.n_outstanding == \
            alloc.num_pages - alloc.n_reserved
        mapped = Counter(p for i in g.slot_ids
                         for p in sched.slots[i].page_ids)
        cached = g.prefix.pages() if g.prefix is not None else set()
        # the group's private range [n_reserved, num_pages)
        for p in set(mapped) | cached:
            assert alloc.n_reserved <= p < alloc.num_pages, \
                f"group {g.gid} references foreign page {p}"
        for i in g.slot_ids:
            s = sched.slots[i]
            assert len(s.page_ids) == len(set(s.page_ids))
        assert 0 not in mapped and 0 not in cached
        assert set(mapped) | cached == set(alloc.outstanding)
        for p in alloc.outstanding:
            assert alloc.refcount(p) == mapped[p] + (1 if p in cached else 0)
            assert alloc.writable(p) == (alloc.refcount(p) == 1)
        if g.prefix is None:
            assert all(c == 1 for c in mapped.values())
    for s in sched.slots:
        n = len(s.page_ids)
        row = eng.page_table[s.slot]
        if s.request is not None and not s.prefilling:
            assert row[:n].tolist() == s.page_ids
            assert (row[n:] == 0).all()
        else:
            assert (row == 0).all()


@given(arch=st.sampled_from(SOAK_ARCHS),
       reqs=st.lists(st.tuples(st.integers(0, len(PROMPT_LENS) - 1),
                               st.sampled_from((2, 4, 6))),
                     min_size=3, max_size=7),
       pool=st.integers(MIN_POOL, MAX_POOL),
       demand=st.booleans(),
       policy=st.sampled_from(("fewest", "lifo")),
       watermark=st.integers(0, 2),
       share=st.booleans(),
       groups=st.sampled_from((1, 2)))
@settings(max_examples=MAX_EXAMPLES, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
def test_serve_soak_invariants_and_bitmatch(arch, reqs, pool, demand,
                                            policy, watermark, share,
                                            groups):
    sched = ServeScheduler(
        _fresh(_soak_engine(arch)), pool_pages=pool,
        reserve="demand" if demand else "lifetime",
        preempt_policy=policy,
        admit_watermark=watermark if demand else 0,
        prefix_cache=share,
        device_groups=groups)  # 2: slots 2/1, pages split — uneven is the
    #                            production case (batch % groups != 0)
    rids = {}
    for idx, max_new in reqs:
        rid = sched.submit(_soak_prompts(arch, share)[idx], max_new=max_new)
        if rid is not None:
            rids[rid] = (idx, max_new)

    steps = 0
    while sched.step() or len(sched.queue):
        _check_invariants(sched)
        steps += 1
        assert steps < STEP_CAP, (
            f"drain did not finish in {STEP_CAP} steps (reqs={reqs}, "
            f"pool={pool}, demand={demand}, share={share}, "
            f"groups={groups})")

    _check_invariants(sched)
    for g in sched.groups:
        cached = g.prefix.pages() if g.prefix is not None else set()
        assert set(g.allocator.outstanding) == cached
        assert all(g.allocator.refcount(p) == 1 for p in cached)
    sched.flush_prefix_cache()
    for g in sched.groups:
        assert g.allocator.n_outstanding == 0
    assert (sched.engine.page_table == 0).all()
    assert not sched._suspended
    done = {}
    for res in sched.results:
        assert res.rid not in done
        done[res.rid] = res
    assert sorted(done) == sorted(rids)
    for rid, (idx, max_new) in rids.items():
        assert tuple(done[rid].tokens) == \
            _soak_reference(arch, idx, max_new, share), (
                f"rid {rid} (prompt {idx}, max_new {max_new}) diverged "
                f"(pool={pool}, demand={demand}, share={share}, "
                f"groups={groups}, preempts={sched.n_preempted})")
