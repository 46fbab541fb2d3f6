"""The port's executors against the JAX package's, on the CPU.

Each fixture is built twice on the same numpy data: the JAX package's
(``tests/test_executor_parity.py``, the paper max example of
``tests/test_core_executor.py`` and a dynamic-iteration graph) and its
rewrite with torch functions.  Both run through ``LocalExecutor`` in all
three dispatch modes (greedy placement), through ``SpmdExecutor`` where
the fixture allows, and through ``ChaosLocalExecutor`` kill cases
(``tests/test_fault_async.py``).  Results must agree within 1e-6, and the
reports must agree: segment count, jobs per segment, moved and local
bytes, co-scheduling, dynamic jobs added and recovered jobs.  Both sides
place their workers on one device (JAX's first CPU device, the port's
CPU), so moved bytes are 0 and local bytes carry the accounting.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from test_core_executor import max_registry, paper_max_graph
from test_executor_parity import (fix_chunkwise_chain, fix_chunkwise_reduce,
                                  fix_dynamic_control, fix_sliced_refs,
                                  fix_two_producers)

MODES = ("sync", "pipelined", "dataflow")
TOL = dict(atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the fixtures, rewritten with torch functions on the same data
# ---------------------------------------------------------------------------


def t_chunkwise_chain():
    reg = tc.FunctionRegistry()
    reg.register(1, lambda c: c * 2.0 + 1.0)
    reg.register(2, lambda c: torch.tanh(c) + 3.0)
    g = tc.JobGraph()
    g.add_segment([tc.Job("J1", 1, 0)])
    g.add_segment([tc.Job("J2", 2, 0, (tc.ChunkRef("J1"),))])
    g.bind_input("J1", np.arange(32, dtype=np.float32).reshape(8, 4),
                 n_chunks=8)
    return g, reg


def _t_total(*cds):
    return tc.ChunkedData.from_arrays(
        [sum(torch.sum(a) for cd in cds for a in cd.arrays())])


def t_chunkwise_reduce():
    reg = tc.FunctionRegistry()
    reg.register(1, lambda c: c * c)
    reg.register(2, _t_total, kind="whole")
    g = tc.JobGraph()
    g.add_segment([tc.Job("P", 1, 0, no_send_back=True)])
    g.add_segment([tc.Job("Q", 2, 1, (tc.ChunkRef("P"),))])
    g.bind_input("P", np.arange(16, dtype=np.float32).reshape(4, 4),
                 n_chunks=4)
    return g, reg


def t_sliced_refs():
    reg = tc.FunctionRegistry()
    reg.register(1, lambda c: c + 0.5)
    reg.register(2, _t_total, kind="whole")
    g = tc.JobGraph()
    g.add_segment([tc.Job("J1", 1, 0)])
    g.add_segment([tc.Job("LO", 2, 1, (tc.ChunkRef("J1", 0, 3),)),
                   tc.Job("HI", 2, 1, (tc.ChunkRef("J1", 3, 6),))])
    g.bind_input("J1", np.arange(24, dtype=np.float32).reshape(6, 4),
                 n_chunks=6)
    return g, reg


def _t_combine_max(*cds):
    vals = [a for cd in cds for a in cd.arrays()]
    return tc.ChunkedData.from_arrays([torch.max(torch.stack(vals))])


def t_two_producers():
    reg = tc.FunctionRegistry()
    reg.register(1, lambda c: c * 2.0)
    reg.register(2, _t_combine_max, kind="whole")
    g = tc.JobGraph()
    g.add_segment([tc.Job("J1", 1, 0), tc.Job("J2", 1, 0)])
    g.add_segment([tc.Job("J3", 2, 1, (tc.ChunkRef("J1"),
                                       tc.ChunkRef("J2")))])
    g.bind_input("J1", np.arange(8, dtype=np.float32).reshape(4, 2),
                 n_chunks=4)
    g.bind_input("J2", -np.arange(8, dtype=np.float32).reshape(4, 2),
                 n_chunks=4)
    return g, reg


def _dynamic(pkg, halve, first, bound):
    """Control job re-enqueueing ``halve`` until max|value| <= 1 (the
    Jacobi pattern), written once for both packages."""
    reg = pkg.FunctionRegistry()
    reg.register(1, halve)
    state = {"last": "H0", "iters": 0}

    def check(cd, ctx):
        v = float(np.max(np.abs(np.asarray(cd.get_data_chunk(0).data))))
        if v > 1.0:
            state["iters"] += 1
            nxt = f"H{state['iters']}"
            ctx.add_job(pkg.Job(nxt, 1, 0, (pkg.ChunkRef(state["last"]),)), 1)
            ctx.add_job(pkg.Job(f"C{state['iters']}", 9, 1,
                                (pkg.ChunkRef(nxt),)), 2)
            state["last"] = nxt
        return cd

    reg.register(9, check, kind="control")
    g = pkg.JobGraph()
    g.add_segment([pkg.Job("H0", 1, 0)])
    g.add_segment([pkg.Job("C0", 9, 1, (pkg.ChunkRef("H0"),))])
    g.bind_input("H0", bound(first), n_chunks=1)
    return g, reg


def t_dynamic_control():
    return _dynamic(tc, lambda c: c / 2, np.array([[48.0, -64.0]]),
                    lambda a: a.astype(np.float32))


def j_dynamic_iteration():
    return _dynamic(jc, lambda c: c / 2, np.array([64.0]), lambda a: a)


def t_dynamic_iteration():
    return _dynamic(tc, lambda c: c / 2, np.array([64.0]),
                    lambda a: a.astype(np.float32))


_MAX_DATA = np.random.default_rng(0).standard_normal(1000).astype(np.float32)


def j_paper_max():
    return paper_max_graph(_MAX_DATA, split=600), max_registry()


def t_paper_max():
    reg = tc.FunctionRegistry()
    reg.register(1, torch.max)
    reg.register(2, _t_combine_max, kind="whole")
    g = tc.parse_job_text("J1(1,0,0), J2(1,0,0); J3(2,1,R1 R2);")
    g.bind_input("J1", _MAX_DATA[:600], n_chunks=6)
    g.bind_input("J2", _MAX_DATA[600:], n_chunks=4)
    return g, reg


# name -> (JAX factory, port factory, SPMD-compatible)
FIXTURES = {
    "chunkwise-chain": (fix_chunkwise_chain, t_chunkwise_chain, True),
    "chunkwise-reduce": (fix_chunkwise_reduce, t_chunkwise_reduce, True),
    "sliced-refs": (fix_sliced_refs, t_sliced_refs, True),
    "two-producers": (fix_two_producers, t_two_producers, True),
    "dynamic-control": (fix_dynamic_control, t_dynamic_control, False),
    "dynamic-iteration": (j_dynamic_iteration, t_dynamic_iteration, False),
    "paper-max": (j_paper_max, t_paper_max, True),
}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _flat(val) -> np.ndarray:
    """Executor-independent view of one job's result: the flat
    concatenation of its chunks (Local) or its stacked rows (SPMD)."""
    def np_(x):
        return x.float().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x, np.float32)
    if isinstance(val, (jc.ChunkedData, tc.ChunkedData)):
        if not len(val):
            return np.zeros((0,), np.float32)
        return np.concatenate([np_(c.data).ravel() for c in val])
    return np_(val).ravel()


def _report_view(rep):
    return {"segments": [(s.index, sorted(s.jobs), s.moved_bytes,
                          s.local_bytes, sorted(s.co_scheduled),
                          list(s.recovered_jobs)) for s in rep.segments],
            "moved": rep.moved_bytes, "local": rep.local_bytes,
            "dynamic": rep.dynamic_jobs_added}


def _clusters(max_workers=4, **kw):
    return (jc.VirtualCluster(jax.devices()[:1], n_schedulers=1,
                              max_workers=max_workers, **kw),
            tc.VirtualCluster([torch.device("cpu")], n_schedulers=1,
                              max_workers=max_workers, **kw))


def _assert_results_match(jres, tres):
    assert set(tres) == set(jres)
    for name in jres:
        np.testing.assert_allclose(_flat(tres[name]), _flat(jres[name]),
                                   err_msg=name, **TOL)


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(FIXTURES))
def test_local_executor_matches_jax(name, mode):
    jfix, tfix, _ = FIXTURES[name]
    (jg, jreg), (tg, treg) = jfix(), tfix()
    jcl, tcl = _clusters()
    jres, jrep = jc.LocalExecutor(jcl, jreg, mode=mode).run(jg)
    tres, trep = tc.LocalExecutor(tcl, treg, mode=mode).run(tg)
    _assert_results_match(jres, tres)
    assert _report_view(trep) == _report_view(jrep)
    assert trep.summary() == jrep.summary()
    assert tg.names() == jg.names()


@pytest.mark.parametrize("name", [n for n, f in FIXTURES.items() if f[2]])
def test_spmd_executor_matches_jax(name):
    jfix, tfix, _ = FIXTURES[name]
    (jg, jreg), (tg, treg) = jfix(), tfix()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jres, jrep = jc.SpmdExecutor(mesh, jreg).run(jg)
    tres, trep = tc.SpmdExecutor("cpu", treg).run(tg)
    _assert_results_match(jres, tres)
    assert _report_view(trep) == _report_view(jrep)


def test_cost_strategy_and_co_scheduling_match_jax():
    """Paper §3.3's 2×2-threads-on-4-cores co-scheduling, and the cost
    strategy's placements (same workers, same report) on a two-segment
    graph."""
    def build(pkg):
        reg = pkg.FunctionRegistry()
        reg.register(7, lambda c: c + 1)
        g = pkg.JobGraph()
        g.add_segment([pkg.Job("J1", 7, 2), pkg.Job("J2", 7, 2),
                       pkg.Job("J3", 7, 1, no_send_back=True)])
        g.add_segment([pkg.Job("J4", 7, 1, (pkg.ChunkRef("J3"),))])
        for j in ("J1", "J2", "J3"):
            g.bind_input(j, np.zeros(4, np.float32), n_chunks=2)
        return g, reg
    for strategy in ("greedy", "cost"):
        jcl, tcl = _clusters(cores_per_worker=4)
        (jg, jreg), (tg, treg) = build(jc), build(tc)
        jex = jc.LocalExecutor(jcl, jreg, strategy=strategy)
        tex = tc.LocalExecutor(tcl, treg, strategy=strategy)
        jres, jrep = jex.run(jg)
        tres, trep = tex.run(tg)
        _assert_results_match(jres, tres)
        assert _report_view(trep) == _report_view(jrep)
        assert trep.segments[0].co_scheduled
        assert ({n: r.owner_worker for n, r in tex.store.records.items()}
                == {n: r.owner_worker for n, r in jex.store.records.items()})


def _square_sum(pkg, total):
    reg = pkg.FunctionRegistry()
    reg.register(1, lambda c: c * c)
    reg.register(2, total, kind="whole")
    g = pkg.JobGraph()
    g.add_segment([pkg.Job("P", 1, 0, no_send_back=True)])
    g.add_segment([pkg.Job("Q", 2, 1, (pkg.ChunkRef("P"),))])
    g.bind_input("P", np.arange(6, dtype=np.float32), n_chunks=3)
    return g, reg


def _lineage(pkg, total):
    reg = pkg.FunctionRegistry()
    reg.register("a", lambda c: c * 2)
    reg.register("b", lambda c: c + 10)
    reg.register("out", total, kind="whole")
    g = pkg.JobGraph()
    g.add_segment([pkg.Job("A", "a", 1, no_send_back=True)])
    g.add_segment([pkg.Job("B", "b", 1, (pkg.ChunkRef("A"),),
                           no_send_back=True)])
    g.add_segment([pkg.Job("OUT", "out", 1, (pkg.ChunkRef("B"),))])
    g.bind_input("A", np.arange(4, dtype=np.float32), n_chunks=2)
    return g, reg


def _j_total(*cds):
    return jc.ChunkedData.from_arrays(
        [sum(jnp.sum(a) for cd in cds for a in cd.arrays())])


# graph factory, injector plan, max_workers
CHAOS = {
    "kill-after-1-job": (_square_sum,
                         lambda inj: inj.kill_after_jobs(worker=0, n=1), 3),
    "lineage-before-segment-2": (
        _lineage, lambda inj: inj.kill_before_segment(worker=0, segment=2),
        1),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CHAOS))
def test_chaos_recovery_matches_jax(case, mode):
    build, plan, max_workers = CHAOS[case]
    (jg, jreg), (tg, treg) = build(jc, _j_total), build(tc, _t_total)
    jcl, tcl = _clusters(max_workers=max_workers)
    jinj, tinj = plan(jc.FaultInjector()), plan(tc.FaultInjector())
    jres, jrep = jc.ChaosLocalExecutor(jcl, jreg, jinj, mode=mode).run(jg)
    tres, trep = tc.ChaosLocalExecutor(tcl, treg, tinj, mode=mode).run(tg)
    _assert_results_match(jres, tres)
    assert tinj.killed == jinj.killed
    assert trep.recovered_jobs == jrep.recovered_jobs
    assert trep.recovered_jobs, "the kill must force a recomputation"


def test_release_consumed_and_block_per_job_match_jax():
    for pkg, total in ((jc, _j_total), (tc, _t_total)):
        g, reg = _square_sum(pkg, total)
        cl = _clusters()[pkg is tc]
        ex = pkg.LocalExecutor(cl, reg, block_per_job=True)
        res, _ = ex.run(g, release_consumed=True)
        assert ex.store.records["P"].data is None
        assert float(res["Q"].to_array()) == pytest.approx(55.0)


def test_heartbeat_expiry_matches_jax():
    """A worker that stops beating is failed on the same tick in both
    packages, and its retained result is lost."""
    lost = {}
    for pkg, total in ((jc, _j_total), (tc, _t_total)):
        g, reg = _square_sum(pkg, total)
        cl = _clusters(max_workers=2)[pkg is tc]
        ex = pkg.LocalExecutor(cl, reg)
        ex.run(g)
        hb = pkg.Heartbeat(cl, max_missed=1)
        owner = ex.store.records["P"].owner_worker
        per_tick = []
        for _ in range(4):
            for w in cl.alive_workers():
                if w.wid != owner:
                    hb.beat(w.wid)
            per_tick.append(hb.tick(ex.store))
        assert not cl.workers[owner].alive
        lost[pkg] = per_tick
    assert lost[tc] == lost[jc] and ["P"] in lost[tc]


# ---------------------------------------------------------------------------
# the host loop checked every CHECK_EVERY iterations (the port's while_loop)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("check_every", [1, 3, 16])
@pytest.mark.parametrize("start,max_iters", [(64.0, 100), (64.0, 4),
                                             (0.5, 10), (1e6, 30)])
def test_masked_loop_matches_while_loop(start, max_iters, check_every,
                                        monkeypatch):
    """Same final carry and iteration count as ``lax.while_loop``,
    whether ``cond`` turns false mid-run, at the start or never, for any
    spacing of the host's condition checks."""
    monkeypatch.setattr(tc.executor, "CHECK_EVERY", check_every)
    def body(c):
        return c[0] / 2, c[1] + 1

    def cond(c):
        return jnp.abs(c[0]).max() > 1 if isinstance(c[0], jax.Array) \
            else c[0].abs().max() > 1

    def jcond(state):
        i, c = state
        return jnp.logical_and(i < max_iters, cond(c))

    n_j, (xj, kj) = jax.lax.while_loop(
        jcond, lambda s: (s[0] + 1, body(s[1])),
        (jnp.zeros((), jnp.int32),
         (jnp.asarray([start, -start / 3], jnp.float32),
          jnp.zeros((), jnp.int32))))
    (xt, kt), n_t = tc.run_while_loop(
        body, cond, (torch.tensor([start, -start / 3]), torch.tensor(0)),
        max_iters)
    assert n_t == int(n_j) == int(kt) == int(kj)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))


@pytest.mark.parametrize("check_every", [1, 4, 16])
@pytest.mark.parametrize("start", [0, 3, 10, 11])
def test_while_loop_stops_at_first_false_condition(start, check_every,
                                                   monkeypatch):
    """A condition that turns true again after it first fails: the loop
    stops at the first failure, as ``lax.while_loop`` does, even though
    the rest of the block saw it hold again."""
    monkeypatch.setattr(tc.executor, "CHECK_EVERY", check_every)
    calls = []

    def body(c):
        calls.append(1)
        return c + 1

    def cond(c):                        # false on 10, 11 and 12 only
        return (c < 10) | (c > 12)

    n_j, xj = jax.lax.while_loop(
        lambda s: jnp.logical_and(s[0] < 40, cond(s[1])),
        lambda s: (s[0] + 1, body(s[1])),
        (jnp.zeros((), jnp.int32), jnp.asarray(start, jnp.int32)))
    calls.clear()
    xt, n_t = tc.run_while_loop(body, cond, torch.tensor(start), 40)
    assert (n_t, int(xt)) == (int(n_j), int(xj))
    assert len(calls) < n_t + check_every + 1


def test_spmd_run_iterative_matches_jax():
    spec_args = dict(body=lambda c: c * 0.5, max_iters=50)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jx, jn = jc.SpmdExecutor(jmesh, jc.FunctionRegistry()).run_iterative(
        jc.IterativeSpec(cond=lambda c: jnp.max(c) > 0.01, **spec_args),
        jnp.asarray([3.0, 5.0]))
    tx, tn = tc.SpmdExecutor("cpu", tc.FunctionRegistry()).run_iterative(
        tc.IterativeSpec(cond=lambda c: c.max() > 0.01, **spec_args),
        torch.tensor([3.0, 5.0]))
    assert tn == jn
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
