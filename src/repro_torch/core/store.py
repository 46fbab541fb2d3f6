"""Durable job store — sqlite-backed persistence for the cluster runtime.

The paper's §5 names the cost of ``no_send_back``: "in case a worker has to
be shut down, all results computed so far are lost and have to be
re-computed".  The executors recover by *recomputing* (lineage recovery);
this module removes the recomputation for anything that already finished by
persisting results keyed on **content identity** — the registered function
name plus a canonical hash of the input arrays — so a restarted run (or a
run that lost its master process entirely) resumes from ``done`` rows
instead of re-executing them.

Three tables (and ``meta``):

* ``jobs``    — one row per content-identity key: state machine
                ``pending → running → done`` (or ``lost`` when the owning
                worker dies mid-job), retry count, and the result payload —
                small results inline as an npz blob, large ones spilled to
                ``<store>.d/<key>.npz``.
* ``workers`` — executor/worker registrations with wall-clock
                ``last_heartbeat`` stamps; the master's monitor *discovers*
                dead workers by heartbeat expiry instead of being told via
                an explicit ``fail()`` call.
* ``requests``— serve-path host-retained state (generated tokens of
                suspended requests), so recompute-on-resume survives a
                master restart, not just a worker death.

The schema, the npz payloads and :func:`job_key` are the JAX package's, so
one store file serves both packages.  Tensors and arrays alike are
canonicalised on the CPU (:func:`to_numpy`): a contiguous numpy array, with
bfloat16 — which numpy lacks — as its raw 2-byte words in a ``|V2`` array.
That is what ``np.savez`` writes for an ``ml_dtypes.bfloat16`` array, and
:func:`job_key` hashes it under the dtype name ``bfloat16``, so the same
values hash alike in both packages.  A 0-d array keeps its shape (the JAX
package's canonical form makes it 1-d; :func:`job_key` hashes it as that
package does).  Everything read back is a CPU tensor (:func:`from_numpy`;
``|V2`` reads as bfloat16).

Concurrency: WAL journal mode + busy_timeout makes concurrent writers from
the master and every worker process safe; within one process a single
connection is shared behind a lock (sqlite serialises at the VFS level
across processes, we serialise at the connection level within one).
"""
from __future__ import annotations

import hashlib
import io
import os
import sqlite3
import threading
import time
from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import torch

__all__ = ["JobStore", "job_key", "to_numpy", "from_numpy"]

#: the canonical numpy form of a bfloat16 array: its raw 2-byte words
BF16_NP = np.dtype("V2")


def to_numpy(a: Any) -> np.ndarray:
    """Canonical host form of a tensor or array: a C-contiguous numpy array
    on the CPU, of the same shape; bfloat16 becomes its raw words under
    :data:`BF16_NP`."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_NP)
        return t.numpy()
    arr = np.asarray(a)
    return arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)


def from_numpy(arr: np.ndarray) -> torch.Tensor:
    """The CPU tensor of a canonical array (:data:`BF16_NP` → bfloat16);
    it shares the array's memory."""
    arr = np.asarray(arr)
    if arr.dtype == BF16_NP:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == BF16_NP else str(arr.dtype)


def job_key(fn_name: str, inputs: Iterable[Any]) -> str:
    """Content identity of a job: registered function name + canonical hash
    of every input (dtype name, shape, raw bytes).  Two jobs with the same
    key compute the same result, whatever their graph-local names are —
    which is exactly what lets a *restarted* run hit rows written by a
    previous incarnation of the same graph."""
    h = hashlib.sha256()
    h.update(fn_name.encode())
    for a in inputs:
        arr = to_numpy(a)
        h.update(b"|")
        h.update(_dtype_name(arr).encode())
        h.update(str(arr.shape or (1,)).encode())
        h.update(arr.reshape(-1).view(np.uint8))     # the raw bytes, no copy
    return h.hexdigest()


def _savez(fields: Mapping[str, Any]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: to_numpy(v) for k, v in fields.items()})
    return buf.getvalue()


def _unpack(src) -> list[torch.Tensor]:
    """The tensors of an npz payload: a blob, or the path of a spill
    file (read straight from disk)."""
    with np.load(io.BytesIO(src) if isinstance(src, bytes) else src) as z:
        return [from_numpy(z[f"a{i}"]) for i in range(len(z.files))]


_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
    key        TEXT PRIMARY KEY,
    name       TEXT,
    fn         TEXT,
    state      TEXT NOT NULL DEFAULT 'pending',
    worker     INTEGER,
    retries    INTEGER NOT NULL DEFAULT 0,
    payload    BLOB,
    spill      TEXT,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS workers (
    wid            INTEGER PRIMARY KEY,
    pid            INTEGER,
    started_at     REAL NOT NULL,
    last_heartbeat REAL NOT NULL,
    alive          INTEGER NOT NULL DEFAULT 1
);
CREATE TABLE IF NOT EXISTS requests (
    rid        TEXT PRIMARY KEY,
    payload    BLOB NOT NULL,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS meta (
    k TEXT PRIMARY KEY,
    v TEXT
);
"""


class JobStore:
    """One sqlite file = one durable run.  Safe for one writer per process
    and many processes (WAL); every method is atomic."""

    STATES = ("pending", "running", "done", "lost")

    def __init__(self, path: str | os.PathLike, *,
                 spill_bytes: int = 1 << 20):
        self.path = os.fspath(path)
        self.spill_bytes = spill_bytes
        self.spill_dir = self.path + ".d"
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(self.path, timeout=30.0,
                                     check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute("PRAGMA busy_timeout=30000")
        with self._lock, self._conn:
            self._conn.executescript(_SCHEMA)

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # -- job state machine -------------------------------------------------
    def state(self, key: str) -> str | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT state FROM jobs WHERE key=?", (key,)).fetchone()
        return row[0] if row else None

    def mark_running(self, key: str, *, name: str = "", fn: str = "",
                     worker: int | None = None) -> None:
        """Claim a job (pending/lost → running); done rows are untouched —
        the caller should have taken the memoised result instead."""
        now = time.time()
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO jobs(key, name, fn, state, worker, updated_at) "
                "VALUES(?,?,?,'running',?,?) "
                "ON CONFLICT(key) DO UPDATE SET "
                "  state=CASE WHEN jobs.state='done' THEN 'done' ELSE 'running' END, "
                "  name=excluded.name, fn=excluded.fn, "
                "  worker=excluded.worker, updated_at=excluded.updated_at",
                (key, name, fn, worker, now))

    def bump_retries(self, key: str) -> int:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE jobs SET retries=retries+1, updated_at=? WHERE key=?",
                (time.time(), key))
            row = self._conn.execute(
                "SELECT retries FROM jobs WHERE key=?", (key,)).fetchone()
        return int(row[0]) if row else 0

    def put_result(self, key: str, arrays: Sequence[Any], *,
                   name: str = "", fn: str = "",
                   worker: int | None = None) -> None:
        """Persist a finished job's result (state → done).  Results whose
        arrays hold more than ``spill_bytes`` go to a spill file under the
        run dir, written straight from the arrays; the row keeps only the
        relative filename."""
        fields = {f"a{i}": to_numpy(a) for i, a in enumerate(arrays)}
        spill = None
        payload: bytes | None = None
        if sum(a.nbytes for a in fields.values()) > self.spill_bytes:
            os.makedirs(self.spill_dir, exist_ok=True)
            spill = key + ".npz"
            tmp = os.path.join(self.spill_dir, spill + ".tmp")
            with open(tmp, "wb") as f:
                np.savez(f, **fields)
            os.replace(tmp, os.path.join(self.spill_dir, spill))
        else:
            payload = _savez(fields)
        now = time.time()
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO jobs(key, name, fn, state, worker, payload, spill, updated_at) "
                "VALUES(?,?,?,'done',?,?,?,?) "
                "ON CONFLICT(key) DO UPDATE SET state='done', "
                "  name=excluded.name, fn=excluded.fn, worker=excluded.worker, "
                "  payload=excluded.payload, spill=excluded.spill, "
                "  updated_at=excluded.updated_at",
                (key, name, fn, worker, payload, spill, now))

    def load_result(self, key: str) -> list[torch.Tensor] | None:
        """Memoisation hit: the tensors of a ``done`` row, else None."""
        with self._lock:
            row = self._conn.execute(
                "SELECT state, payload, spill FROM jobs WHERE key=?",
                (key,)).fetchone()
        if row is None or row[0] != "done":
            return None
        _, payload, spill = row
        if payload is not None:
            return _unpack(payload)
        try:
            return _unpack(os.path.join(self.spill_dir, spill))
        except FileNotFoundError:
            return None

    def mark_lost(self, key: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE jobs SET state='lost', updated_at=? "
                "WHERE key=? AND state!='done'", (time.time(), key))

    def mark_worker_jobs_lost(self, wid: int) -> list[str]:
        """A worker died: every job it was *running* is lost (its in-flight
        work is gone; its done rows stay — they were persisted first)."""
        with self._lock, self._conn:
            rows = self._conn.execute(
                "SELECT key FROM jobs WHERE worker=? AND state='running'",
                (wid,)).fetchall()
            self._conn.execute(
                "UPDATE jobs SET state='lost', updated_at=? "
                "WHERE worker=? AND state='running'", (time.time(), wid))
        return [r[0] for r in rows]

    def counts(self) -> dict[str, int]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT state, COUNT(*) FROM jobs GROUP BY state").fetchall()
        return {state: n for state, n in rows}

    def n_done(self) -> int:
        return self.counts().get("done", 0)

    def payload_bytes(self) -> dict[str, int]:
        """Bytes of the ``done`` payloads: ``{"inline": .., "spilled": ..}``
        (inline blobs in the database, spill files on disk)."""
        with self._lock:
            inline, = self._conn.execute(
                "SELECT COALESCE(SUM(LENGTH(payload)), 0) FROM jobs "
                "WHERE state='done'").fetchone()
            spills = [r[0] for r in self._conn.execute(
                "SELECT spill FROM jobs WHERE state='done' "
                "AND spill IS NOT NULL").fetchall()]
        spilled = 0
        for name in spills:
            try:
                spilled += os.path.getsize(os.path.join(self.spill_dir, name))
            except FileNotFoundError:
                pass
        return {"inline": int(inline), "spilled": spilled}

    def gc(self, *, max_age_s: float | None = None,
           max_rows: int | None = None,
           now: float | None = None,
           exempt_requests: Iterable[str] = ()) -> dict[str, int]:
        """Prune ``done`` rows (and their spill files) so a long-lived store
        does not grow without bound: drop rows older than ``max_age_s``,
        then — of the survivors — keep only the ``max_rows`` most recently
        updated.  Only ``done`` rows are ever candidates: pending/running/
        lost rows carry live scheduling state and dropping one would
        re-execute (or worse, double-claim) in-flight work, so the state
        filter is structural, not a fast path.

        ``requests`` rows (serve suspended-token payloads) are pruned by
        the same ``max_age_s`` cutoff: the serving path deletes them at
        retire, so in steady state none reach the cutoff — rows that DO are
        orphans of a master that died before retiring them.
        ``exempt_requests`` protects keys a live run still counts on (its
        running/suspended rids); ``max_rows`` deliberately does not apply —
        age is the only evidence a request row is orphaned, whereas result
        rows are re-computable memoisation.

        Returns ``{"rows": pruned_rows, "spill_files": unlinked_files,
        "request_rows": pruned_request_rows}``."""
        if max_age_s is None and max_rows is None:
            return {"rows": 0, "spill_files": 0, "request_rows": 0}
        if max_age_s is not None and max_age_s < 0:
            raise ValueError(f"max_age_s {max_age_s} must be >= 0")
        if max_rows is not None and max_rows < 0:
            raise ValueError(f"max_rows {max_rows} must be >= 0")
        now = time.time() if now is None else now
        with self._lock, self._conn:
            doomed = []
            if max_age_s is not None:
                doomed += self._conn.execute(
                    "SELECT key, spill FROM jobs "
                    "WHERE state='done' AND updated_at < ?",
                    (now - max_age_s,)).fetchall()
            if max_rows is not None:
                survivors = self._conn.execute(
                    "SELECT key, spill FROM jobs WHERE state='done' "
                    + ("AND updated_at >= ? " if max_age_s is not None else "")
                    + "ORDER BY updated_at DESC",
                    ((now - max_age_s,) if max_age_s is not None else ()),
                ).fetchall()
                doomed += survivors[max_rows:]
            self._conn.executemany(
                "DELETE FROM jobs WHERE key=? AND state='done'",
                [(key,) for key, _ in doomed])
            req_doomed: list[str] = []
            if max_age_s is not None:
                exempt = set(exempt_requests)
                req_doomed = [rid for (rid,) in self._conn.execute(
                    "SELECT rid FROM requests WHERE updated_at < ?",
                    (now - max_age_s,)).fetchall() if rid not in exempt]
                self._conn.executemany(
                    "DELETE FROM requests WHERE rid=?",
                    [(r,) for r in req_doomed])
        spilled = 0
        for _, spill in doomed:
            if spill is None:
                continue
            try:
                os.remove(os.path.join(self.spill_dir, spill))
                spilled += 1
            except FileNotFoundError:
                pass
        return {"rows": len(doomed), "spill_files": spilled,
                "request_rows": len(req_doomed)}

    # -- worker registration / heartbeats ---------------------------------
    def register_worker(self, wid: int, pid: int | None = None) -> None:
        """Registration counts as the first beat — a worker spawned just
        before a monitor tick must not be declared dead before it runs a
        single job."""
        now = time.time()
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO workers(wid, pid, started_at, last_heartbeat, alive) "
                "VALUES(?,?,?,?,1) "
                "ON CONFLICT(wid) DO UPDATE SET pid=excluded.pid, "
                "  started_at=excluded.started_at, "
                "  last_heartbeat=excluded.last_heartbeat, alive=1",
                (wid, pid, now, now))

    def beat(self, wid: int) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE workers SET last_heartbeat=? WHERE wid=?",
                (time.time(), wid))

    def heartbeats(self) -> dict[int, float]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT wid, last_heartbeat FROM workers WHERE alive=1").fetchall()
        return {wid: hb for wid, hb in rows}

    def expired(self, timeout_s: float, *, boot_grace_s: float | None = None,
                now: float | None = None) -> list[int]:
        """Wids whose heartbeat is older than ``timeout_s`` — discovery, not
        notification: nobody calls fail(), the silence itself is the signal.

        A row whose ``pid`` is still NULL was registered by the master but
        its process has not checked in yet (interpreter boot + imports can
        far exceed the beat interval); such workers only expire after
        ``boot_grace_s``."""
        now = time.time() if now is None else now
        with self._lock:
            rows = self._conn.execute(
                "SELECT wid, last_heartbeat, pid FROM workers "
                "WHERE alive=1").fetchall()
        out = []
        for wid, hb, pid in rows:
            limit = timeout_s if pid is not None else max(
                timeout_s, boot_grace_s if boot_grace_s is not None else timeout_s)
            if now - hb > limit:
                out.append(wid)
        return out

    def booted_wids(self) -> list[int]:
        """Alive workers whose process has checked in (stamped its pid)."""
        with self._lock:
            rows = self._conn.execute(
                "SELECT wid FROM workers WHERE alive=1 AND pid IS NOT NULL"
            ).fetchall()
        return [r[0] for r in rows]

    def mark_worker_dead(self, wid: int) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE workers SET alive=0 WHERE wid=?", (wid,))

    # -- serve-path request persistence -----------------------------------
    def put_request(self, rid: str, fields: Mapping[str, Any]) -> None:
        """Persist a request's host-retained recovery state (tokens etc.)
        as an npz of named arrays."""
        blob = _savez(fields)
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO requests(rid, payload, updated_at) VALUES(?,?,?) "
                "ON CONFLICT(rid) DO UPDATE SET payload=excluded.payload, "
                "  updated_at=excluded.updated_at",
                (rid, blob, time.time()))

    def get_request(self, rid: str) -> dict[str, torch.Tensor] | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT payload FROM requests WHERE rid=?", (rid,)).fetchone()
        if row is None:
            return None
        with np.load(io.BytesIO(row[0])) as z:
            return {k: from_numpy(z[k]) for k in z.files}

    def get_requests(self) -> dict[str, dict[str, torch.Tensor]]:
        with self._lock:
            rids = [r[0] for r in self._conn.execute(
                "SELECT rid FROM requests").fetchall()]
        return {rid: req for rid in rids
                if (req := self.get_request(rid)) is not None}

    def delete_request(self, rid: str) -> None:
        with self._lock, self._conn:
            self._conn.execute("DELETE FROM requests WHERE rid=?", (rid,))

    # -- meta / hygiene ----------------------------------------------------
    def set_meta(self, k: str, v: str) -> None:
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO meta(k, v) VALUES(?,?) "
                "ON CONFLICT(k) DO UPDATE SET v=excluded.v", (k, v))

    def get_meta(self, k: str) -> str | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM meta WHERE k=?", (k,)).fetchone()
        return row[0] if row else None

    def check_leaks(self) -> list[str]:
        """Store hygiene after a run fully drains: no rows stuck ``running``
        on a dead worker, no orphaned spill files.  Returns human-readable
        problems (empty list == clean)."""
        problems: list[str] = []
        with self._lock:
            stuck = self._conn.execute(
                "SELECT j.key, j.worker FROM jobs j "
                "LEFT JOIN workers w ON j.worker = w.wid "
                "WHERE j.state='running' AND (w.alive IS NULL OR w.alive=0)"
            ).fetchall()
            spills = {r[0] for r in self._conn.execute(
                "SELECT spill FROM jobs WHERE spill IS NOT NULL").fetchall()}
        for key, wid in stuck:
            problems.append(f"job {key[:12]} stuck running on dead worker {wid}")
        if os.path.isdir(self.spill_dir):
            for fname in os.listdir(self.spill_dir):
                if fname.endswith(".tmp") or fname not in spills:
                    problems.append(f"orphan spill file {fname}")
        return problems
