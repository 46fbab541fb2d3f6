"""The port's sqlite JobStore: the JAX package's store tests, run on the
port's store, and parity with the JAX package — ``job_key`` equal across the
packages (fp32, int32, int64, bool, bfloat16, 0-d and non-contiguous
inputs, numpy arrays and tensors alike), and a store file written by
either package read by the other (results, requests, meta, heartbeats).
Hermetic tmp-path stores, no processes."""
import os
import threading
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.store import JobStore as JaxJobStore
from repro.core.store import job_key as jax_job_key
from repro_torch.core.store import JobStore, from_numpy, job_key, to_numpy


@pytest.fixture
def store(tmp_path):
    s = JobStore(tmp_path / "jobs.sqlite")
    yield s
    s.close()


# -- content identity ------------------------------------------------------

def test_job_key_deterministic_and_input_sensitive():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    k1 = job_key("fn", [a])
    assert k1 == job_key("fn", [a.copy()])
    assert k1 != job_key("other_fn", [a])
    assert k1 != job_key("fn", [a + 1])
    assert k1 != job_key("fn", [a.astype(np.float64)])
    assert k1 != job_key("fn", [a.reshape(3, 2)])


def test_job_key_ignores_memory_layout():
    a = np.arange(9, dtype=np.float64).reshape(3, 3)
    assert job_key("fn", [a.T]) == job_key("fn", [np.ascontiguousarray(a.T)])


# -- results ---------------------------------------------------------------

def test_result_roundtrip_inline(store):
    arrays = [np.arange(5.0), np.ones((2, 2), np.int32)]
    store.put_result("k1", arrays, name="J1", fn="f")
    assert store.state("k1") == "done"
    got = store.load_result("k1")
    assert len(got) == 2
    for a, b in zip(arrays, got):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        np.testing.assert_array_equal(a, b.numpy())
        assert a.dtype == b.numpy().dtype


def test_result_spills_above_threshold(tmp_path):
    s = JobStore(tmp_path / "jobs.sqlite", spill_bytes=256)
    try:
        big = np.random.default_rng(0).standard_normal((64, 64))
        s.put_result("big", [big])
        files = os.listdir(s.spill_dir)
        assert files == ["big.npz"]
        np.testing.assert_array_equal(s.load_result("big")[0].numpy(), big)
        assert s.check_leaks() == []
    finally:
        s.close()


def test_load_result_misses(store):
    assert store.load_result("nope") is None
    store.mark_running("k", name="J", fn="f", worker=0)
    assert store.load_result("k") is None  # running, not done


# -- job state machine -----------------------------------------------------

def test_running_then_done_then_running_stays_done(store):
    store.mark_running("k", name="J", fn="f", worker=1)
    assert store.state("k") == "running"
    store.put_result("k", [np.zeros(2)], worker=1)
    assert store.state("k") == "done"
    # a concurrent claim after completion must not regress the state
    store.mark_running("k", worker=2)
    assert store.state("k") == "done"


def test_worker_death_loses_only_its_running_jobs(store):
    store.register_worker(0)
    store.register_worker(1)
    store.mark_running("r0", worker=0)
    store.mark_running("r1", worker=1)
    store.put_result("d0", [np.ones(1)], worker=0)
    lost = store.mark_worker_jobs_lost(0)
    assert lost == ["r0"]
    assert store.state("r0") == "lost"
    assert store.state("r1") == "running"
    assert store.state("d0") == "done"  # persisted results survive the death
    assert store.bump_retries("r0") == 1
    assert store.counts() == {"lost": 1, "running": 1, "done": 1}


# -- heartbeats ------------------------------------------------------------

def test_registration_counts_as_first_beat(store):
    store.register_worker(0, pid=123)
    assert store.expired(10.0) == []
    hb = store.heartbeats()
    assert set(hb) == {0}
    assert time.time() - hb[0] < 5.0


def test_expiry_is_discovered_not_announced(store):
    store.register_worker(0)
    store.register_worker(1)
    time.sleep(0.05)
    store.beat(1)
    assert store.expired(0.04) == [0]
    store.mark_worker_dead(0)
    assert store.heartbeats().keys() == {1}
    assert store.expired(0.04) == []


# -- serve request persistence --------------------------------------------

def test_request_roundtrip_and_delete(store):
    store.put_request("r1", {"tokens": np.array([1, 2, 3]),
                             "token_s": np.array(42.5)})
    store.put_request("r1", {"tokens": np.array([1, 2, 3, 4]),
                             "token_s": np.array(42.5)})
    reqs = store.get_requests()
    assert list(reqs) == ["r1"]
    np.testing.assert_array_equal(reqs["r1"]["tokens"].numpy(), [1, 2, 3, 4])
    store.delete_request("r1")
    assert store.get_requests() == {}
    assert store.get_request("r1") is None


# -- hygiene ---------------------------------------------------------------

def test_check_leaks_flags_stuck_jobs_and_orphan_spills(tmp_path):
    s = JobStore(tmp_path / "jobs.sqlite", spill_bytes=64)
    try:
        s.register_worker(0)
        s.mark_running("stuck", worker=0)
        s.mark_worker_dead(0)
        os.makedirs(s.spill_dir, exist_ok=True)
        with open(os.path.join(s.spill_dir, "junk.npz"), "wb") as f:
            f.write(b"x")
        problems = s.check_leaks()
        assert any("stuck" in p for p in problems)
        assert any("junk.npz" in p for p in problems)
        s.put_result("stuck", [np.zeros(64)], worker=0)
        os.remove(os.path.join(s.spill_dir, "junk.npz"))
        assert s.check_leaks() == []
    finally:
        s.close()


def test_concurrent_writers_share_one_store(tmp_path):
    """Many threads hammering one connection (the in-process contract; the
    cross-process contract is WAL + busy_timeout, exercised by the
    procworker tests)."""
    s = JobStore(tmp_path / "jobs.sqlite")
    try:
        def work(i):
            for j in range(20):
                s.put_result(f"k{i}_{j}", [np.full(3, i * 100 + j)])
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert s.n_done() == 160
        np.testing.assert_array_equal(s.load_result("k7_19")[0].numpy(),
                                      np.full(3, 719))
    finally:
        s.close()


def test_meta_roundtrip(store):
    assert store.get_meta("graph") is None
    store.set_meta("graph", "demo-v1")
    store.set_meta("graph", "demo-v2")
    assert store.get_meta("graph") == "demo-v2"


# -- gc --------------------------------------------------------------------

def test_gc_noop_without_limits(store):
    store.put_result("k", [np.zeros(2)])
    assert store.gc() == {"rows": 0, "spill_files": 0, "request_rows": 0}
    assert store.state("k") == "done"


def test_gc_prunes_by_age(store):
    now = time.time()
    store.put_result("old", [np.zeros(2)])
    store.put_result("fresh", [np.ones(2)])
    with store._lock, store._conn:
        store._conn.execute("UPDATE jobs SET updated_at=? WHERE key='old'",
                            (now - 3600,))
    pruned = store.gc(max_age_s=60, now=now)
    assert pruned == {"rows": 1, "spill_files": 0, "request_rows": 0}
    assert store.state("old") is None
    assert store.load_result("fresh") is not None


def test_gc_caps_rows_keeping_most_recent(store):
    now = time.time()
    for i in range(6):
        store.put_result(f"k{i}", [np.full(2, i)])
        with store._lock, store._conn:
            store._conn.execute("UPDATE jobs SET updated_at=? WHERE key=?",
                                (now - 100 + i, f"k{i}"))
    pruned = store.gc(max_rows=2, now=now)
    assert pruned["rows"] == 4
    assert store.state("k5") == "done" and store.state("k4") == "done"
    assert all(store.state(f"k{i}") is None for i in range(4))


def test_gc_never_touches_running_rows(store):
    """The leak assertion: in-flight scheduling state is structurally
    exempt — neither an ancient age nor a zero row cap may drop a row
    that is not ``done``."""
    now = time.time()
    store.register_worker(0)
    for key, state in (("run", "running"), ("pend", "pending"),
                       ("lost", "lost")):
        store.mark_running(key, worker=0)
    with store._lock, store._conn:
        store._conn.execute("UPDATE jobs SET state='pending' WHERE key='pend'")
        store._conn.execute("UPDATE jobs SET state='lost' WHERE key='lost'")
        store._conn.execute("UPDATE jobs SET updated_at=?", (now - 9999,))
    pruned = store.gc(max_age_s=0, max_rows=0, now=now)
    assert pruned["rows"] == 0 and pruned["spill_files"] == 0
    assert store.state("run") == "running"
    assert store.state("pend") == "pending"
    assert store.state("lost") == "lost"


def test_gc_unlinks_spill_files(tmp_path):
    s = JobStore(tmp_path / "jobs.sqlite", spill_bytes=64)
    try:
        now = time.time()
        s.put_result("big_old", [np.zeros(64)])
        s.put_result("big_new", [np.ones(64)])
        with s._lock, s._conn:
            s._conn.execute(
                "UPDATE jobs SET updated_at=? WHERE key='big_old'",
                (now - 3600,))
        pruned = s.gc(max_age_s=60, now=now)
        assert pruned == {"rows": 1, "spill_files": 1, "request_rows": 0}
        assert sorted(os.listdir(s.spill_dir)) == ["big_new.npz"]
        # pruning left no orphans behind for the hygiene check to flag
        assert s.check_leaks() == []
    finally:
        s.close()


def test_gc_age_and_cap_compose(store):
    now = time.time()
    for i in range(5):
        store.put_result(f"k{i}", [np.full(2, i)])
        with store._lock, store._conn:
            age = 3600 if i < 2 else 100 - i
            store._conn.execute("UPDATE jobs SET updated_at=? WHERE key=?",
                                (now - age, f"k{i}"))
    # age drops k0/k1; of the survivors (k2, k3, k4) the cap keeps the two
    # most recent (k4 is youngest: age 100-i decreases with i)
    pruned = store.gc(max_age_s=600, max_rows=2, now=now)
    assert pruned["rows"] == 3
    assert store.state("k4") == "done" and store.state("k3") == "done"
    assert all(store.state(k) is None for k in ("k0", "k1", "k2"))


def test_gc_prunes_stale_request_rows_exempting_live(store):
    """Serve suspended-token rows: the serving path deletes them at retire,
    so a row older than the cutoff is an orphan of a dead master — UNLESS a
    live run claims it via ``exempt_requests``.  ``max_rows`` never applies
    to requests (age is the only orphan evidence)."""
    now = time.time()
    for rid in ("serve.suspended:0", "serve.suspended:1", "serve.suspended:2"):
        store.put_request(rid, {"tokens": np.array([1, 2, 3])})
    with store._lock, store._conn:
        store._conn.execute(
            "UPDATE requests SET updated_at=? WHERE rid!='serve.suspended:2'",
            (now - 3600,))
    pruned = store.gc(max_age_s=60, now=now,
                      exempt_requests=["serve.suspended:1"])
    assert pruned == {"rows": 0, "spill_files": 0, "request_rows": 1}
    assert store.get_request("serve.suspended:0") is None   # stale orphan
    assert store.get_request("serve.suspended:1") is not None  # live-exempt
    assert store.get_request("serve.suspended:2") is not None  # fresh
    # a rows-only gc leaves request rows alone: no age => no orphan evidence
    pruned = store.gc(max_rows=0, now=now)
    assert pruned["request_rows"] == 0
    assert store.get_request("serve.suspended:1") is not None


# -- parity with the JAX package --------------------------------------------

def _arrays():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    return {
        "float32": f32,
        "int32": rng.integers(-9, 9, (4, 2)).astype(np.int32),
        "int64": rng.integers(-9, 9, (7,)).astype(np.int64),
        "bool": rng.integers(0, 2, (2, 3)).astype(bool),
        "float64_0d": np.asarray(2.5),
        "noncontiguous": f32.T,
        "strided": f32[:, ::2],
    }


@pytest.mark.parametrize("name", list(_arrays()))
def test_job_key_matches_jax(name):
    a = _arrays()[name]
    want = jax_job_key("fn", [a, a])
    assert job_key("fn", [a, a]) == want
    assert job_key("fn", [torch.from_numpy(np.ascontiguousarray(a)), a]) \
        == want


def test_job_key_of_noncontiguous_tensors_matches_jax():
    t = torch.arange(15, dtype=torch.float32).reshape(3, 5)
    for view in (t.T, t[:, ::2], t[1:, 1:].T):
        assert not view.is_contiguous()
        assert job_key("fn", [view]) == jax_job_key("fn", [view.numpy()])


def test_job_key_bfloat16_matches_jax():
    """bfloat16 has no numpy dtype: the port hashes a bf16 tensor as the
    JAX package hashes the ``ml_dtypes.bfloat16`` array of the same values
    (dtype name ``bfloat16``, the raw 2-byte words), contiguous or not."""
    vals = np.random.default_rng(1).standard_normal((4, 6)).astype(np.float32)
    jarr = np.asarray(jnp.asarray(vals, jnp.bfloat16))
    t = torch.from_numpy(vals).to(torch.bfloat16)
    assert jarr.dtype == ml_dtypes.bfloat16
    assert job_key("f", [t]) == jax_job_key("f", [jarr])
    assert job_key("f", [t.T]) == jax_job_key("f", [np.ascontiguousarray(
        jarr.T)])
    assert job_key("f", [t]) != job_key("f", [t.float()])
    # the canonical form round-trips the tensor bit for bit
    back = from_numpy(to_numpy(t))
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)
    assert to_numpy(t).tobytes() == jarr.tobytes()


def _fill(s, arrays, bf16):
    """The same content through either package's store."""
    s.put_result("inline", arrays)
    s.put_result("bf16", [bf16])
    s.put_request("serve.suspended:3", {
        "tokens": np.array([5, 6, 7], np.int64),
        "token_s": np.array([0.5, 1.25]),
        "n_preempts": np.array([2], np.int64)})
    s.set_meta("graph", "demo-v1")
    s.register_worker(4, pid=99)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_file_reads_across_packages(tmp_path, writer):
    arrays = [a for k, a in _arrays().items() if k != "float64_0d"]
    vals = np.random.default_rng(2).standard_normal((2, 3)).astype(np.float32)
    jbf16 = np.asarray(jnp.asarray(vals, jnp.bfloat16))
    tbf16 = torch.from_numpy(vals).to(torch.bfloat16)
    path = tmp_path / "jobs.sqlite"
    big = np.arange(4096, dtype=np.float64)

    w = (JaxJobStore if writer == "jax" else JobStore)(path, spill_bytes=4096)
    _fill(w, arrays, jbf16 if writer == "jax" else tbf16)
    w.put_result("spilled", [big])
    w.close()
    r = (JobStore if writer == "jax" else JaxJobStore)(path, spill_bytes=4096)
    try:
        got = r.load_result("inline")
        assert len(got) == len(arrays)
        for a, b in zip(arrays, got):
            b = b.numpy() if isinstance(b, torch.Tensor) else b
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(b, a)
        spilled = r.load_result("spilled")[0]
        np.testing.assert_array_equal(np.asarray(spilled), big)
        [bf] = r.load_result("bf16")
        if writer == "jax":          # the port reads the raw words as bf16
            assert bf.dtype == torch.bfloat16 and torch.equal(bf, tbf16)
        else:                        # as the JAX package reads its own
            assert bf.tobytes() == jbf16.tobytes()
        req = r.get_requests()["serve.suspended:3"]
        assert [int(t) for t in req["tokens"]] == [5, 6, 7]
        assert [float(t) for t in req["token_s"]] == [0.5, 1.25]
        assert int(np.asarray(req["n_preempts"]).reshape(-1)[0]) == 2
        assert r.get_meta("graph") == "demo-v1"
        assert set(r.heartbeats()) == {4} and r.booted_wids() == [4]
        assert r.counts() == {"done": 3} and r.check_leaks() == []
    finally:
        r.close()
