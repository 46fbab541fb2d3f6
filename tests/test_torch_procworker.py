"""The port's ProcessExecutor: real spawn workers, durable memoisation,
heartbeat recovery — the JAX package's tests, run on the port (tiny graphs,
2 workers, numpy-level children; the master's cluster on the CPU) — and the
demo's oracle against the JAX package's, bit for bit."""
import os
import signal
import threading
import time

import numpy as np
import pytest

import torch

from repro.apps import procdemo as jax_procdemo
from repro_torch.apps import procdemo
from repro_torch.core import ProcessExecutor, VirtualCluster
from repro_torch.core.store import JobStore

SHAPE = dict(width=2, depth=3, dim=8, seed=3)


def _make_executor(store, **kw):
    kw.setdefault("mode", "pipelined")
    kw.setdefault("heartbeat_interval_s", 0.1)
    kw.setdefault("heartbeat_max_missed", 3)
    return ProcessExecutor(VirtualCluster([torch.device("cpu")],
                                          n_schedulers=1, max_workers=2),
                           procdemo.make_registry(),
                           procdemo.WORKER_FNS_SPEC,
                           store=store, **kw)


def _assert_bitwise(results, expected):
    for name, arrays in expected.items():
        got = results[name]
        assert len(got) == len(arrays)
        for a, b in zip(arrays, got.arrays()):
            assert b.dtype == torch.float64
            np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


def test_oracle_matches_jax_procdemo():
    """The port's demo computes the JAX package's demo, bit for bit."""
    for shape in (SHAPE, dict(width=3, depth=2, dim=5, seed=0)):
        want = jax_procdemo.expected_results(**shape)
        got = procdemo.expected_results(**shape)
        assert sorted(got) == sorted(want)
        for name in want:
            for a, b in zip(want[name], got[name]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("mode", ["pipelined", "dataflow"])
def test_process_executor_matches_oracle(tmp_path, mode):
    expected = procdemo.expected_results(**SHAPE)
    with _make_executor(tmp_path / "jobs.sqlite", mode=mode) as ex:
        results, report = ex.run(procdemo.build_graph(**SHAPE))
        _assert_bitwise(results, expected)
        assert ex.n_executed == len(expected)
        assert ex.n_memoised == 0
        assert report.memoised_jobs == []
        assert ex.jobstore.n_done() == len(expected)


def test_restarted_run_serves_every_job_from_the_store(tmp_path):
    """Master-restart memoisation: a second executor over the same store
    path (fresh processes, fresh cluster) re-executes nothing."""
    path = tmp_path / "jobs.sqlite"
    expected = procdemo.expected_results(**SHAPE)
    with _make_executor(path) as ex:
        first, _ = ex.run(procdemo.build_graph(**SHAPE))
    with _make_executor(path) as ex2:
        second, report = ex2.run(procdemo.build_graph(**SHAPE))
        assert ex2.n_executed == 0
        assert ex2.n_memoised == len(expected)
        assert sorted(report.memoised_jobs) == sorted(expected)
    _assert_bitwise(second, expected)
    for name in expected:
        for a, b in zip(first[name].arrays(), second[name].arrays()):
            assert torch.equal(a, b)


def test_sigkill_worker_recovered_by_heartbeat_expiry(tmp_path, monkeypatch):
    """SIGKILL one live worker process mid-run: nobody calls fail() — the
    monitor discovers the silence, re-places in-flight jobs, spawns a
    replacement, and the run completes bit-identically."""
    monkeypatch.setenv("REPRO_PROCDEMO_SLEEP", "0.15")
    expected = procdemo.expected_results(**SHAPE)
    ex = _make_executor(tmp_path / "jobs.sqlite", heartbeat_max_missed=2,
                        job_timeout_s=20.0)
    try:
        ex._ensure_started()
        victim_wid, victim = next(iter(ex.procs.items()))
        n_workers0 = len(ex.cluster.workers)

        def kill_once_booted():
            # kill only after the child stamped its pid: expiry then runs on
            # the beat timeout, not the (long) boot grace
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                if victim_wid in ex.jobstore.booted_wids():
                    os.kill(victim.process.pid, signal.SIGKILL)
                    return
                time.sleep(0.02)

        killer = threading.Thread(target=kill_once_booted, daemon=True)
        killer.start()
        results, report = ex.run(procdemo.build_graph(**SHAPE))
        killer.join(timeout=15.0)
        _assert_bitwise(results, expected)
        # discovery happened: the slot was failed and replaced
        deadline = time.monotonic() + 5.0
        while not victim.lost and time.monotonic() < deadline:
            time.sleep(0.05)
        assert victim.lost
        assert not any(w.alive and w.wid == victim_wid
                       for w in ex.cluster.workers)
        assert len(ex.cluster.workers) > n_workers0
        assert ex.jobstore.heartbeats().keys() == {
            w.wid for w in ex.cluster.alive_workers()}
    finally:
        ex.close()


def test_store_survives_for_inspection_after_close(tmp_path):
    path = tmp_path / "jobs.sqlite"
    with _make_executor(path) as ex:
        ex.run(procdemo.build_graph(**SHAPE))
    s = JobStore(path)
    try:
        assert s.check_leaks() == []
        assert s.counts() == {"done": s.n_done()}
    finally:
        s.close()


def test_host_registry_matches_process_children(tmp_path):
    """``make_registry(host=True)``: the same graph on LocalExecutor's
    worker threads computes the children's bits."""
    from repro_torch.core import LocalExecutor

    ex = LocalExecutor(VirtualCluster([torch.device("cpu")], max_workers=2),
                       procdemo.make_registry(host=True), mode="pipelined")
    results, _ = ex.run(procdemo.build_graph(**SHAPE))
    _assert_bitwise(results, procdemo.expected_results(**SHAPE))
