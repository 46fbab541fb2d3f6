"""ProcessExecutor — the durable runtime over real worker processes.

The LocalExecutor's workers are threads sharing one GIL and one address
space: failures must be *announced* (explicit ``fail()``) and every result
dies with the process.  This executor keeps the exact same dispatch
machinery (per-worker queues, pipelined/dataflow modes, master placement,
lineage recovery) but backs each :class:`Worker` slot with a real
``multiprocessing`` *spawn* process and a sqlite :class:`JobStore`:

* results are persisted under **content identity** (`job_key`) before the
  worker replies, so a re-run of the same graph — same process or a fresh
  master after a SIGKILL — serves ``done`` jobs from the store instead of
  recomputing them (memoisation);
* workers stamp wall-clock heartbeats into the store; the master's monitor
  thread *discovers* dead workers by heartbeat expiry (store-backed
  :class:`Heartbeat`) — nothing ever calls ``fail()`` on their behalf;
* dispatch gets a per-job timeout and bounded retry with exponential
  backoff: a lost/silent worker's in-flight jobs are re-placed on live
  workers, and the monitor spawns a replacement process for the dead slot.

Children are *spawn* processes only: a forked child of a parent that has
touched CUDA cannot use the card.  They resolve a function table from a
``"module:attr"`` spec (see ``_procworker_child``) and set up whatever
device they use inside those functions.  Every chunk crosses the process
boundary as a numpy array in the store's canonical form
(:func:`~repro_torch.core.store.to_numpy`), its bytes written straight down
a pipe (the JAX package pickles them through a ``multiprocessing.Queue``:
at full model width that is gigabytes a job, copied four times), and comes
back into the master's results as a CPU tensor.  A sender thread writes
each request, so the master keeps reading replies while a large request
drains.  The master keeps its normal registry for job
*kinds* and for control functions, which still run on the host.

Because every process result is sent back **and** persisted, a worker death
loses only its in-flight jobs — the paper's ``no_send_back`` recompute cost
(§5) disappears: lineage recovery becomes a store lookup.
"""
from __future__ import annotations

import itertools
import multiprocessing
import tempfile
import threading
import time

import numpy as np

from . import _procworker_child
from ._procworker_child import (array_specs, recv_arrays, send_arrays,
                                widen_pipe)
from .executor import LocalExecutor, SegmentReport
from .fault import Heartbeat
from .job import ChunkedData, DataChunk, Job, JobGraph
from .registry import ControlContext, FunctionKind, FunctionRegistry
from .scheduler import CostModelParams, VirtualCluster, Worker
from .store import JobStore, from_numpy, job_key, to_numpy

__all__ = ["ProcessExecutor", "WorkerFunctionError"]


class WorkerFunctionError(RuntimeError):
    """A worker function raised — deterministic, so not retried."""


class _ProcHandle:
    """Master-side channel to one worker process: the write end of its
    request pipe and the read end of its reply pipe.  ``ch_lock``
    serialises request/response pairs (never held while taking the
    executor lock, so lineage recovery under the dispatch lock cannot
    deadlock a finishing job that needs it); ``sender`` is the thread
    writing the current request; ``eof`` is set once the reply pipe has
    closed (the child is gone, which the heartbeat monitor will
    discover)."""

    def __init__(self, wid: int, process, req, resp):
        self.wid = wid
        self.process = process
        self.req = req
        self.resp = resp
        self.lost = False
        self.eof = False
        self.sender: threading.Thread | None = None
        self.ch_lock = threading.Lock()
        self.seq = itertools.count()

    def send(self, header: tuple, chunk_lists) -> None:
        """Write one request from a thread of its own; a worker that died
        meanwhile is the monitor's to find."""
        def write():
            try:
                self.req.send(header)
                for arrays in chunk_lists:
                    send_arrays(self.req, arrays)
            except OSError:
                pass
        self.sender = threading.Thread(target=write, daemon=True,
                                       name=f"hypar-send-w{self.wid}")
        self.sender.start()

    def close(self) -> None:
        self.req.close()
        self.resp.close()


class ProcessExecutor(LocalExecutor):
    """LocalExecutor whose worker slots are real spawn processes.

    ``worker_fns`` — ``"module:attr"`` spec of the child-side function
    table: a dict mapping ``str(fid)`` of every non-control registry entry
    to a plain function over numpy arrays (the paper's fat-worker
    registration).
    ``store`` — path to the sqlite store (or a JobStore; its path is
    reused — each process opens its own connection).  None ⇒ a fresh
    temporary store (no cross-run memoisation).
    ``boot_grace_s`` — how long a spawned worker may take to check in (a
    child imports torch before it does) before the monitor declares it
    dead; once checked in, ``heartbeat_max_missed`` beats of
    ``heartbeat_interval_s`` of silence are the limit.
    """

    def __init__(self, cluster: VirtualCluster, registry: FunctionRegistry,
                 worker_fns: str, *,
                 store: JobStore | str | None = None,
                 mode: str = "pipelined",
                 strategy: str = "greedy",
                 cost_params: CostModelParams | None = None,
                 job_timeout_s: float = 30.0,
                 max_retries: int = 3,
                 backoff_s: float = 0.05,
                 heartbeat_interval_s: float = 0.25,
                 heartbeat_max_missed: int = 5,
                 boot_grace_s: float = 60.0,
                 **kw):
        super().__init__(cluster, registry, mode=mode, strategy=strategy,
                         cost_params=cost_params, **kw)
        self.worker_fns = worker_fns
        if store is None:
            self._tmpdir = tempfile.TemporaryDirectory(prefix="repro-jobstore-")
            store = self._tmpdir.name + "/jobs.sqlite"
        else:
            self._tmpdir = None
        self.jobstore = store if isinstance(store, JobStore) else JobStore(store)
        self.job_timeout_s = job_timeout_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.heartbeat_interval_s = heartbeat_interval_s
        self.heartbeat_max_missed = heartbeat_max_missed
        self.n_executed = 0
        self.n_memoised = 0
        self.procs: dict[int, _ProcHandle] = {}
        self._mp = multiprocessing.get_context("spawn")
        self._hb = Heartbeat(cluster, heartbeat_max_missed,
                             store=self.jobstore,
                             interval_s=heartbeat_interval_s,
                             boot_grace_s=boot_grace_s)
        self._monitor: threading.Thread | None = None
        self._stop = threading.Event()
        self._closed = False

    # -- process lifecycle -------------------------------------------------
    def _spawn_proc(self, wid: int) -> _ProcHandle:
        req_r, req_w = self._mp.Pipe(duplex=False)
        resp_r, resp_w = self._mp.Pipe(duplex=False)
        for conn in (req_w, resp_w):
            widen_pipe(conn)
        # register before start: the row's registration beat covers the
        # child's import window so the monitor never reaps a booting worker
        self.jobstore.register_worker(wid)
        p = self._mp.Process(
            target=_procworker_child.worker_main,
            args=(wid, self.jobstore.path, self.worker_fns,
                  self.heartbeat_interval_s, req_r, resp_w),
            daemon=True, name=f"hypar-proc-w{wid}")
        p.start()
        # the child holds its ends now: closing ours lets a dead child's
        # pipes report end-of-file and a broken pipe
        req_r.close()
        resp_w.close()
        ph = _ProcHandle(wid, p, req_w, resp_r)
        self.procs[wid] = ph
        self._hb.register(wid)
        return ph

    def _ensure_started(self) -> None:
        if self._closed:
            raise RuntimeError("ProcessExecutor is closed")
        if not self.cluster.workers:
            for _ in range(self.cluster.max_workers):
                self.cluster.spawn_worker()
        for w in self.cluster.alive_workers():
            ph = self.procs.get(w.wid)
            if ph is None or ph.lost:
                self._spawn_proc(w.wid)
        if self._monitor is None:
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             daemon=True, name="hypar-monitor")
            self._monitor.start()

    def wait_booted(self, timeout_s: float) -> float:
        """Start the workers (if not yet) and block until every live one
        has checked in.  Returns the seconds waited; raises on timeout."""
        self._ensure_started()
        t0 = time.monotonic()
        while True:
            live = {w for w, ph in self.procs.items() if not ph.lost}
            if live <= set(self.jobstore.booted_wids()):
                return time.monotonic() - t0
            if time.monotonic() - t0 > timeout_s:
                raise RuntimeError(f"workers {sorted(live)} did not check in "
                                   f"within {timeout_s} s")
            time.sleep(0.02)

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval_s):
            try:
                for wid in self._hb.expired_wids():
                    self._declare_lost(wid)
            except Exception:  # monitor must survive transient store errors
                pass

    def _declare_lost(self, wid: int) -> None:
        """Heartbeat-expiry discovery: reap the process, fail the slot,
        mark its in-flight jobs lost, spawn a replacement."""
        ph = self.procs.get(wid)
        if ph is None or ph.lost:
            return
        ph.lost = True
        try:
            ph.process.terminate()
            ph.process.join(timeout=1.0)
        except Exception:
            pass
        self.jobstore.mark_worker_dead(wid)
        self.jobstore.mark_worker_jobs_lost(wid)
        with self._lock:
            dead = next((w for w in self.cluster.workers if w.wid == wid), None)
            if dead is not None and dead.alive:
                dead.fail()
            self.store.invalidate_worker(wid)
            try:
                repl = self.cluster.spawn_worker()
            except RuntimeError:
                repl = None
        if repl is not None:
            self._spawn_proc(repl.wid)

    def close(self) -> None:
        """Stop the monitor and shut every worker process down."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
            self._monitor = None
        for ph in self.procs.values():
            if ph.lost or (ph.sender is not None and ph.sender.is_alive()):
                continue          # a request still draining: terminate below
            try:
                ph.req.send(("stop",))
            except OSError:
                pass
        for ph in self.procs.values():
            ph.process.join(timeout=5.0)
            if ph.process.is_alive():
                ph.process.terminate()
                ph.process.join(timeout=1.0)
            ph.close()
        self.procs.clear()
        self.jobstore.close()
        if self._tmpdir is not None:
            self._tmpdir.cleanup()

    def __enter__(self) -> "ProcessExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatch ----------------------------------------------------------
    def run(self, graph: JobGraph, **kw):
        self._ensure_started()
        return super().run(graph, **kw)

    def _host_inputs(self, job: Job, graph: JobGraph,
                     report: SegmentReport) -> list[list[np.ndarray]]:
        """Host-side input resolution: one list of canonical numpy host
        arrays per input (the process boundary is the transfer; no device
        moves here).  Lost results go through lineage recovery."""
        inputs: list[list[np.ndarray]] = []
        for ref in job.inputs:
            rec = self.store.records.get(ref.job)
            if rec is None or rec.data is None:
                self._recover(ref.job, graph, report)
                rec = self.store.get(ref.job)
            sel = ref.select(rec.data)
            report.local_bytes += sum(c.nbytes for c in sel)
            inputs.append([to_numpy(c.data) for c in sel])
        if job.name in graph.bound_inputs:
            inputs.insert(0, [to_numpy(c.data)
                              for c in graph.bound_inputs[job.name]])
        return inputs

    def _execute_on(self, job: Job, worker: Worker, graph: JobGraph,
                    report: SegmentReport,
                    ctx: ControlContext | None = None) -> tuple[ChunkedData, float]:
        rf = self.registry[job.fn]
        if rf.kind == FunctionKind.CONTROL:
            # control jobs stay on the master host (paper §3.3)
            return super()._execute_on(job, worker, graph, report, ctx)
        with self._lock:
            chunk_lists = self._host_inputs(job, graph, report)
        key = job_key(str(job.fn), [a for lst in chunk_lists for a in lst])
        t0 = time.perf_counter()
        memo = self.jobstore.load_result(key)
        if memo is not None:
            out = ChunkedData([DataChunk(t) for t in memo])
            with self._lock:
                self.n_memoised += 1
                report.memoised_jobs.append(job.name)
                worker.jobs_done += 1
                self.store.put(job, out, worker)
            return out, time.perf_counter() - t0
        arrays = self._dispatch_with_retry(job, worker, key, rf.kind,
                                           chunk_lists, report)
        out = ChunkedData([DataChunk(from_numpy(a)) for a in arrays])
        elapsed = time.perf_counter() - t0
        with self._lock:
            self.n_executed += 1
            worker.jobs_done += 1
            self.store.put(job, out, worker)
            if self._master is not None:
                self._master.observe(job.fn, elapsed)
        return out, elapsed

    def _live_worker(self, preferred: Worker, deadline: float) -> Worker | None:
        """The placed worker if its process is live, else the least-loaded
        live one; blocks (until ``deadline``) for the monitor's replacement
        when no process is currently live."""
        while True:
            with self._lock:
                ph = self.procs.get(preferred.wid)
                if preferred.alive and ph is not None and not ph.lost:
                    return preferred
                cands = [w for w in self.cluster.alive_workers()
                         if (p := self.procs.get(w.wid)) is not None
                         and not p.lost]
                if cands:
                    return min(cands, key=lambda w: w.jobs_done)
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.02)

    def _dispatch_with_retry(self, job: Job, worker: Worker, key: str,
                             kind: str, chunk_lists: list[list[np.ndarray]],
                             report: SegmentReport) -> list[np.ndarray]:
        delay = self.backoff_s
        outcome = "no live worker"
        respawn_wait = max(2 * self.heartbeat_interval_s
                           * self.heartbeat_max_missed, 5.0)
        for attempt in range(self.max_retries + 1):
            if attempt:
                time.sleep(delay)
                delay *= 2
                with self._lock:
                    report.recovered_jobs.append(job.name)
            target = self._live_worker(worker,
                                       time.monotonic() + respawn_wait)
            if target is None:
                continue
            worker = target
            ph = self.procs[worker.wid]
            self.jobstore.mark_running(key, name=job.name, fn=str(job.fn),
                                       worker=worker.wid)
            outcome, payload = self._dispatch_once(ph, key, job, kind,
                                                   chunk_lists)
            if outcome == "ok":
                return payload
            self.jobstore.mark_lost(key)
        raise RuntimeError(
            f"{job.name}: dispatch failed after {self.max_retries + 1} "
            f"attempts (last: {outcome})")

    def _dispatch_once(self, ph: _ProcHandle, key: str, job: Job, kind: str,
                       chunk_lists: list[list[np.ndarray]]):
        """One request/response round trip with a per-job deadline.  Loss is
        only ever observed through the monitor's heartbeat-expiry flag
        (``ph.lost``) or the deadline — never ``Process.is_alive()``."""
        deadline = time.monotonic() + self.job_timeout_s
        if not ph.ch_lock.acquire(timeout=self.job_timeout_s):
            return "timeout", None
        try:
            if ph.sender is not None:
                # a timed-out earlier request may still be draining: two
                # writers would interleave their bytes
                ph.sender.join(max(deadline - time.monotonic(), 0.0))
                if ph.sender.is_alive():
                    return "timeout", None
            seq = next(ph.seq)
            ph.send(("job", seq, key, str(job.fn), kind,
                     [array_specs(a) for a in chunk_lists]), chunk_lists)
            while True:
                if ph.lost:
                    return "lost", None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return "timeout", None
                if ph.eof:
                    time.sleep(min(0.05, remaining))
                    continue
                if not ph.resp.poll(min(0.05, remaining)):
                    continue
                try:
                    status, rseq, _rkey, payload = ph.resp.recv()
                    if status == "ok":
                        payload = recv_arrays(ph.resp, payload)
                except (EOFError, OSError):
                    ph.eof = True     # wait for the monitor's verdict
                    continue
                if rseq != seq:
                    continue  # stale reply from a timed-out earlier attempt
                if status == "ok":
                    return "ok", payload
                raise WorkerFunctionError(
                    f"{job.name} (fn={job.fn}) failed on worker "
                    f"{ph.wid}:\n{payload}")
        finally:
            ph.ch_lock.release()

