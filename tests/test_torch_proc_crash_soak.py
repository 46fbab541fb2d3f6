"""Tier-2 crash soak for the port's durable process runtime
(``repro_torch.core.procworker.ProcessExecutor`` over
``repro_torch.core.store.JobStore``): the JAX package's
``tests/test_proc_crash_soak.py`` test for test, with its shape, sleeps,
heartbeats and assertions, the master's cluster on the CPU.

Two hard-kill scenarios against the same content-keyed store:

* SIGKILL *worker processes* (twice, including a replacement) mid-run —
  heartbeat expiry alone recovers them and the run completes bit-identically
  with zero store leaks;
* SIGKILL the *master process* (``tests/_torch_soak_driver.py``) mid-run —
  a fresh master over the same store serves the finished prefix as memo
  hits and completes bit-identically.

Both use ``REPRO_PROCDEMO_SLEEP`` to hold jobs in flight long enough for
the kill to land mid-work.  Slow-marked, as the reference's is (boots real
spawn workers many times over): run it with
``PYTHONPATH=src python -m pytest -m slow tests/test_torch_proc_crash_soak.py``.
"""
import os
import signal
import sqlite3
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.apps import procdemo
from repro_torch.core import ProcessExecutor, VirtualCluster
from repro_torch.core.store import JobStore

pytestmark = pytest.mark.slow

SHAPE = dict(width=3, depth=4, dim=8, seed=11)
N_JOBS = SHAPE["width"] * (SHAPE["depth"] + 1) + 1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_soak_driver.py")


def _cluster():
    return VirtualCluster([torch.device("cpu")], n_schedulers=1,
                          max_workers=2)


def _assert_bitwise(results, expected):
    for name, arrays in expected.items():
        got = results[name]
        assert len(got) == len(arrays)
        for a, b in zip(arrays, got.arrays()):
            assert b.dtype == torch.float64
            np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


def _store_worker_pids(path) -> list[int]:
    con = sqlite3.connect(path)
    try:
        return [int(r[0]) for r in con.execute(
            "SELECT pid FROM workers WHERE pid IS NOT NULL")]
    finally:
        con.close()


def _kill(pid: int) -> None:
    try:
        os.kill(pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def test_worker_sigkill_soak_recovers_twice(tmp_path, monkeypatch):
    """Kill a booted worker, then — once its replacement has booted — kill
    again: two heartbeat-expiry recoveries in one run, bit-identical result,
    clean store."""
    monkeypatch.setenv("REPRO_PROCDEMO_SLEEP", "0.15")
    expected = procdemo.expected_results(**SHAPE)
    path = tmp_path / "soak.sqlite"
    ex = ProcessExecutor(_cluster(), procdemo.make_registry(),
                         procdemo.WORKER_FNS_SPEC, store=path,
                         heartbeat_interval_s=0.1, heartbeat_max_missed=2,
                         job_timeout_s=30.0)
    killed: list[int] = []

    def killer():
        deadline = time.monotonic() + 60.0
        while len(killed) < 2 and time.monotonic() < deadline:
            for pid in _store_worker_pids(path):
                if pid not in killed:
                    _kill(pid)
                    killed.append(pid)
                    time.sleep(1.5)   # let the replacement boot + take jobs
                    break
            else:
                time.sleep(0.05)

    try:
        ex._ensure_started()
        t = threading.Thread(target=killer, daemon=True)
        t.start()
        results, report = ex.run(procdemo.build_graph(**SHAPE))
        t.join(timeout=60.0)
        _assert_bitwise(results, expected)
        assert len(killed) == 2
        assert ex.jobstore.n_done() == N_JOBS
    finally:
        ex.close()
    s = JobStore(path)
    try:
        assert s.check_leaks() == []
    finally:
        s.close()


def test_master_sigkill_resume_serves_done_prefix(tmp_path):
    """SIGKILL the whole master process mid-run; a fresh master over the
    same store memoises every finished job and completes bit-identically."""
    expected = procdemo.expected_results(**SHAPE)
    path = tmp_path / "soak.sqlite"
    env = dict(os.environ,
               PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_PROCDEMO_SLEEP="0.2")
    args = [sys.executable, DRIVER, str(path)] + [
        str(SHAPE[k]) for k in ("width", "depth", "dim", "seed")]
    proc = subprocess.Popen(args, env=env, cwd=REPO,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        # wait for real progress, then murder the master mid-segment
        deadline = time.monotonic() + 120.0
        n_done = 0
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                pytest.fail("driver finished before the kill landed — "
                            "raise REPRO_PROCDEMO_SLEEP")
            if path.exists():
                s = JobStore(path)
                try:
                    n_done = s.n_done()
                finally:
                    s.close()
                if n_done >= 3:
                    break
            time.sleep(0.1)
        assert n_done >= 3, "driver made no progress before timeout"
        proc.kill()
        proc.wait(timeout=10.0)
    finally:
        if proc.poll() is None:
            proc.kill()
    # SIGKILL orphans the spawn children (daemon cleanup never ran): reap
    # them so they stop beating into the store mid-resume
    for pid in _store_worker_pids(path):
        _kill(pid)

    ex = ProcessExecutor(_cluster(), procdemo.make_registry(),
                         procdemo.WORKER_FNS_SPEC, store=path,
                         heartbeat_interval_s=0.1, heartbeat_max_missed=3)
    try:
        results, report = ex.run(procdemo.build_graph(**SHAPE))
        _assert_bitwise(results, expected)
        assert ex.n_memoised > 0, "nothing served from the store"
        assert ex.n_executed < N_JOBS, "resume re-executed everything"
        assert ex.n_memoised + ex.n_executed == N_JOBS
        assert ex.n_memoised >= n_done
        assert sorted(set(report.memoised_jobs)) == sorted(report.memoised_jobs)
    finally:
        ex.close()
    s = JobStore(path)
    try:
        assert s.check_leaks() == []
        assert s.counts() == {"done": N_JOBS}
    finally:
        s.close()
