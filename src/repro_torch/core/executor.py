"""Executors — how job graphs actually run.

All executors implement the :class:`BaseExecutor` contract
(``run(graph) -> (results, ExecutionReport)``) so launchers, benchmarks and
apps never special-case the runtime (DESIGN.md §2).

* :class:`LocalExecutor` — the *paper-faithful* runtime.  Workers are pinned
  to individual ``torch.device`` objects; chunk transfers between devices
  are explicit (and accounted), ``no_send_back`` results stay on their
  worker's device.
  Worker failures lose retained results, which are recovered by re-executing
  the producing jobs from the graph (lineage recovery).  Dynamic jobs
  (control functions) are handled on the host, exactly like the paper's
  master re-enqueueing mechanism.

  Three dispatch modes (DESIGN.md §2.3):

  - ``mode="sync"`` — the paper's loop: placements execute one by one on the
    host thread; ``block_per_job=True`` additionally waits for each job's
    device work (precise per-worker timing, e.g. straggler experiments).
  - ``mode="pipelined"`` — per-worker dispatch queues: every placement of a
    segment is issued without host-side blocking (CUDA's asynchronous
    launches overlap the host's dispatch with device work); the host waits
    once at the paper's segment barrier.  Control jobs drain on the host as
    their inputs complete.  Every dispatch thread issues onto its device's
    current stream (one stream per device), so work that one thread issues
    after another thread's producer is ordered behind it.
  - ``mode="dataflow"`` — the barrier relaxed to true dataflow: a job in
    segment *k+1* whose inputs are all available is dispatched before
    segment *k* fully drains (the paper's strict barrier becomes an opt-in
    strictness level).

* :class:`SpmdExecutor` — the *beyond-paper* runtime.  A whole parallel
  segment is fused: same-function chunkwise jobs are batched over a stacked
  chunk axis and run as one ``torch.func.vmap`` call on one device (the
  generalisation of the paper's worker co-scheduling).  Self-re-enqueueing
  iterative patterns (the Jacobi J3) run as one host loop that never
  waits for the device between its sparse condition checks
  (:func:`run_while_loop`).
"""
from __future__ import annotations

import abc
import concurrent.futures
import dataclasses
import threading
import time
from typing import Any, Callable, Iterable

import torch

from .job import ChunkedData, DataChunk, GraphValidationError, Job, JobGraph
from .registry import ControlContext, FunctionKind, FunctionRegistry
from .scheduler import (MasterScheduler, Placement,
                        ResultStore, VirtualCluster, Worker,
                        indexed_device)

__all__ = [
    "ExecutionReport",
    "BaseExecutor",
    "LocalExecutor",
    "SpmdExecutor",
    "IterativeSpec",
    "run_while_loop",
]


# ---------------------------------------------------------------------------
# Reporting / monitoring (paper future work §5: "basic monitoring")
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SegmentReport:
    index: int
    jobs: list[str] = dataclasses.field(default_factory=list)
    moved_bytes: int = 0
    local_bytes: int = 0
    co_scheduled: list[tuple[str, ...]] = dataclasses.field(default_factory=list)
    recovered_jobs: list[str] = dataclasses.field(default_factory=list)
    speculated_jobs: list[str] = dataclasses.field(default_factory=list)
    sim_makespan: float = 0.0
    wall_time: float = 0.0


@dataclasses.dataclass
class ExecutionReport:
    segments: list[SegmentReport] = dataclasses.field(default_factory=list)
    dynamic_jobs_added: int = 0
    mode: str = "sync"

    @property
    def moved_bytes(self) -> int:
        return sum(s.moved_bytes for s in self.segments)

    @property
    def local_bytes(self) -> int:
        return sum(s.local_bytes for s in self.segments)

    @property
    def recovered_jobs(self) -> list[str]:
        return [j for s in self.segments for j in s.recovered_jobs]

    def summary(self) -> str:
        return (f"mode={self.mode} segments={len(self.segments)} "
                f"moved={self.moved_bytes}B "
                f"local={self.local_bytes}B dynamic={self.dynamic_jobs_added} "
                f"recovered={len(self.recovered_jobs)}")


# ---------------------------------------------------------------------------
# Unified executor contract
# ---------------------------------------------------------------------------


class BaseExecutor(abc.ABC):
    """What every runtime must provide: execute a JobGraph, return the
    results directory plus an :class:`ExecutionReport`.

    Implementations differ in *where* jobs run (per-device workers, one
    fused device, …) but not in the contract, so ``apps/`` code is
    runtime-agnostic.
    """

    registry: FunctionRegistry

    @abc.abstractmethod
    def run(self, graph: JobGraph, **kwargs
            ) -> tuple[dict[str, Any], ExecutionReport]:
        """Execute the whole graph; returns (results by job name, report)."""


# ---------------------------------------------------------------------------
# Local (paper-faithful) executor
# ---------------------------------------------------------------------------

MODES = ("sync", "pipelined", "dataflow")
# a worker this many times slower than nominal gets its jobs duplicated
# onto the fastest other alive worker
SPECULATIVE_SLOWDOWN_THRESHOLD = 2.0


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Copy ``t`` to ``device``: asynchronously onto a CUDA device (the
    copy is ordered on the stream before any later work there), blocking
    onto the CPU, whose readers do not wait for a stream."""
    return t.to(device, non_blocking=device.type == "cuda")


def _synchronize(tensors: Iterable[Any]) -> None:
    """Wait for the work queued on every CUDA device among ``tensors``
    (CPU tensors are ready as soon as they exist)."""
    devices = {t.device for t in tensors
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class LocalExecutor(BaseExecutor):
    """Dispatch jobs to per-device workers following the placement plan."""

    def __init__(self, cluster: VirtualCluster, registry: FunctionRegistry, *,
                 block_per_job: bool = False,
                 mode: str = "sync",
                 strategy: str = "greedy"):
        if mode not in MODES:
            raise ValueError(f"unknown dispatch mode {mode!r}; pick from {MODES}")
        self.cluster = cluster
        self.registry = registry
        self.store = ResultStore(cluster)
        # paper semantics: the barrier is at SEGMENT granularity — jobs are
        # dispatched asynchronously and the scheduler waits once per segment
        # (block_per_job=True restores per-job waits for precise worker
        # timing, e.g. in straggler experiments)
        self.block_per_job = block_per_job
        self.mode = mode
        self.strategy = strategy
        # serialises store/report/graph mutation when worker queues dispatch
        # from threads; reentrant because lineage recovery recurses into
        # _execute_on
        self._lock = threading.RLock()
        self._queues: dict[int, concurrent.futures.ThreadPoolExecutor] = {}
        self._inflight: dict[int, int] = {}
        self._master: MasterScheduler | None = None

    # -- plumbing ----------------------------------------------------------------
    def _queue(self, wid: int) -> concurrent.futures.ThreadPoolExecutor:
        """One single-threaded dispatch queue per worker: jobs placed on a
        worker issue in placement order, workers issue concurrently."""
        q = self._queues.get(wid)
        if q is None:
            q = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"hypar-w{wid}")
            self._queues[wid] = q
        return q

    def _shutdown_queues(self) -> None:
        for q in self._queues.values():
            q.shutdown(wait=True)
        self._queues.clear()
        self._inflight.clear()

    def _resolve_inputs(self, job: Job, graph: JobGraph, report: SegmentReport,
                        worker: Worker) -> list[ChunkedData]:
        """Fetch each input ref, moving chunks to the worker's device.

        Lost results (dead worker + no_send_back) trigger lineage recovery:
        the producing job is re-executed (paper §3.1 names exactly this
        recompute cost as the drawback of result retention).
        """
        inputs: list[ChunkedData] = []
        for ref in job.inputs:
            rec = self.store.records.get(ref.job)
            if rec is None or rec.data is None:
                self._recover(ref.job, graph, report)
                rec = self.store.get(ref.job)
            sel = ref.select(rec.data)
            moved = []
            for c in sel:
                if c.data.device != worker.device:
                    report.moved_bytes += c.nbytes
                    moved.append(DataChunk(_to_device(c.data, worker.device)))
                else:
                    report.local_bytes += c.nbytes
                    moved.append(c)
            inputs.append(ChunkedData(moved))
        if job.name in graph.bound_inputs:
            data = graph.bound_inputs[job.name]
            moved = [c if c.data.device == worker.device
                     else DataChunk(_to_device(c.data, worker.device))
                     for c in data]
            inputs.insert(0, ChunkedData(moved))
        return inputs

    def _recover(self, name: str, graph: JobGraph, report: SegmentReport) -> None:
        """Re-execute a job whose result was lost (recursively)."""
        job = graph.job(name)
        # choose any alive worker (fresh placement — the original is dead)
        alive = self.cluster.alive_workers()
        if not alive:
            worker = self.cluster.spawn_worker()
        else:
            worker = min(alive, key=lambda w: w.jobs_done)
        report.recovered_jobs.append(name)
        self._execute_on(job, worker, graph, report)

    # -- execution ----------------------------------------------------------------
    def _execute_on(self, job: Job, worker: Worker, graph: JobGraph,
                    report: SegmentReport,
                    ctx: ControlContext | None = None) -> tuple[ChunkedData, float]:
        """Resolve inputs, run the registered function, record the result.

        The dispatch lock is held only around shared-state access (store
        reads + recovery + report counters, then store.put + feedback) and
        for the whole control branch (graph mutation); chunkwise/whole
        dispatch itself runs unlocked so worker queues overlap transfers
        and kernel launches.
        """
        rf = self.registry[job.fn]
        with self._lock:
            inputs = self._resolve_inputs(job, graph, report, worker)
        t0 = time.perf_counter()
        if rf.kind == FunctionKind.CHUNKWISE:
            if not inputs:
                raise GraphValidationError(
                    f"{job.name}: chunkwise function {job.fn!r} needs input chunks")
            fn = rf.fn
            zipped = list(zip(*[cd.arrays() for cd in inputs]))
            out_chunks = [DataChunk(fn(*args)) for args in zipped]
            out = ChunkedData(out_chunks)
        elif rf.kind == FunctionKind.WHOLE:
            out = rf.fn(*inputs)
            if not isinstance(out, ChunkedData):
                out = ChunkedData.from_arrays(
                    out if isinstance(out, (list, tuple)) else [out])
        elif rf.kind == FunctionKind.CONTROL:
            with self._lock:
                if ctx is None:
                    ctx = ControlContext(graph, job.segment)
                # host copies as CPU tensors (numpy has no bf16)
                host_inputs = [ChunkedData([DataChunk(c.data.cpu())
                                            for c in cd]) for cd in inputs]
                out = rf.fn(*host_inputs, ctx)
                if out is None:
                    out = ChunkedData([])
                elif not isinstance(out, ChunkedData):
                    out = ChunkedData.from_arrays(
                        out if isinstance(out, (list, tuple)) else [out])
                for new_job, seg_idx in ctx.added:
                    graph.add_dynamic(new_job, seg_idx, current=job.segment)
        else:  # pragma: no cover
            raise GraphValidationError(f"unknown kind {rf.kind}")
        if self.block_per_job:
            _synchronize(c.data for c in out)
        elapsed = time.perf_counter() - t0
        with self._lock:
            worker.jobs_done += 1
            self.store.put(job, out, worker)
            if self._master is not None:
                self._master.observe(job.fn, elapsed)
        return out, elapsed

    def _maybe_speculate(self, p: Placement, sreport: SegmentReport) -> Worker:
        """Straggler mitigation: speculatively duplicate on a faster worker
        when the chosen one is degraded."""
        worker = p.worker
        if (worker.slowdown >= SPECULATIVE_SLOWDOWN_THRESHOLD
                and len(self.cluster.alive_workers()) > 1):
            fast = min((w for w in self.cluster.alive_workers()
                        if w.wid != worker.wid),
                       key=lambda w: w.slowdown)
            if fast.slowdown < worker.slowdown:
                sreport.speculated_jobs.append(p.job.name)
                worker = fast
        return worker

    def _segment_barrier(self, names: Iterable[str]) -> None:
        """The paper's segment barrier: wait for every job of the segment
        (a synchronise of each device that holds one of its results)."""
        _synchronize(c.data for name in names
                     if (rec := self.store.records.get(name)) is not None
                     and rec.data is not None for c in rec.data)

    def run(self, graph: JobGraph, *, release_consumed: bool = False
            ) -> tuple[dict, ExecutionReport]:
        """Execute the whole graph; returns (results by job name, report).

        ``release_consumed`` — after a segment completes, release results
        whose every consumer has already run (the paper's scheduler "signals
        them the data is no longer required").
        """
        report = ExecutionReport(mode=self.mode)
        self._master = MasterScheduler(graph, self.cluster,
                                       strategy=self.strategy)
        try:
            if self.mode == "sync":
                self._run_sync(graph, report, release_consumed)
            elif self.mode == "pipelined":
                self._run_pipelined(graph, report, release_consumed)
            else:
                self._run_dataflow(graph, report, release_consumed)
        finally:
            self._shutdown_queues()
            self._master = None
        results = {name: rec.data for name, rec in self.store.records.items()
                   if rec.data is not None}
        return results, report

    # -- mode: sync (the paper's dispatch loop) --------------------------------
    def _run_sync(self, graph: JobGraph, report: ExecutionReport,
                  release_consumed: bool) -> None:
        master = self._master
        seg_idx = 0
        while seg_idx < len(graph.segments):
            segment = graph.segments[seg_idx]
            sreport = SegmentReport(index=seg_idx, jobs=list(segment.names()))
            t0 = time.perf_counter()
            worker_time: dict[int, float] = {}
            n_dynamic_before = graph.n_jobs()
            executed: set[str] = set()
            # fixpoint over same-segment dynamic additions: control jobs may
            # add to the *current* segment, which needs a re-plan pass
            pending = list(segment.jobs)
            while pending:
                placements = master.plan_segment(pending, self.store)
                for p in placements:
                    if p.co_scheduled_with:
                        sreport.co_scheduled.append((p.job.name,) + p.co_scheduled_with)
                    worker = self._maybe_speculate(p, sreport)
                    ctx = ControlContext(graph, seg_idx)
                    _, elapsed = self._execute_on(p.job, worker, graph, sreport, ctx)
                    worker_time[worker.wid] = worker_time.get(worker.wid, 0.0) \
                        + elapsed * worker.slowdown
                    executed.add(p.job.name)
                pending = [j for j in segment.jobs if j.name not in executed]
            n_dynamic_after = graph.n_jobs()
            report.dynamic_jobs_added += max(0, n_dynamic_after - n_dynamic_before)
            if not self.block_per_job:
                self._segment_barrier(executed)
            sreport.jobs = list(segment.names())
            sreport.sim_makespan = max(worker_time.values(), default=0.0)
            sreport.wall_time = time.perf_counter() - t0
            report.segments.append(sreport)
            if release_consumed:
                self._release_dead_results(graph, seg_idx)
            seg_idx += 1

    # -- mode: pipelined (per-worker queues, strict segment barrier) -----------
    def _run_pipelined(self, graph: JobGraph, report: ExecutionReport,
                       release_consumed: bool) -> None:
        master = self._master
        seg_idx = 0
        while seg_idx < len(graph.segments):
            segment = graph.segments[seg_idx]
            sreport = SegmentReport(index=seg_idx, jobs=list(segment.names()))
            t0 = time.perf_counter()
            worker_time: dict[int, float] = {}
            n_dynamic_before = graph.n_jobs()
            executed: set[str] = set()
            pending = list(segment.jobs)
            while pending:
                placements = master.plan_segment(pending, self.store)
                futures: dict[str, tuple[concurrent.futures.Future, Worker]] = {}
                for p in placements:
                    if p.co_scheduled_with:
                        sreport.co_scheduled.append((p.job.name,) + p.co_scheduled_with)
                    worker = self._maybe_speculate(p, sreport)
                    executed.add(p.job.name)
                    if self.registry[p.job.fn].kind == FunctionKind.CONTROL:
                        # host job: all deps live in earlier (drained)
                        # segments, so it runs immediately on the host thread
                        # while device queues fill
                        ctx = ControlContext(graph, seg_idx)
                        _, elapsed = self._execute_on(p.job, worker, graph,
                                                      sreport, ctx)
                        worker_time[worker.wid] = worker_time.get(worker.wid, 0.0) \
                            + elapsed * worker.slowdown
                    else:
                        fut = self._queue(worker.wid).submit(
                            self._execute_on, p.job, worker, graph, sreport)
                        futures[p.job.name] = (fut, worker)
                for name, (fut, worker) in futures.items():
                    _, elapsed = fut.result()  # re-raises worker exceptions
                    worker_time[worker.wid] = worker_time.get(worker.wid, 0.0) \
                        + elapsed * worker.slowdown
                pending = [j for j in segment.jobs if j.name not in executed]
            n_dynamic_after = graph.n_jobs()
            report.dynamic_jobs_added += max(0, n_dynamic_after - n_dynamic_before)
            self._segment_barrier(executed)
            sreport.jobs = list(segment.names())
            sreport.sim_makespan = max(worker_time.values(), default=0.0)
            sreport.wall_time = time.perf_counter() - t0
            report.segments.append(sreport)
            if release_consumed:
                self._release_dead_results(graph, seg_idx)
            seg_idx += 1

    # -- mode: dataflow (relaxed barrier, FIRST_COMPLETED draining) ------------
    def _run_dataflow(self, graph: JobGraph, report: ExecutionReport,
                      release_consumed: bool) -> None:
        """Dependency-driven dispatch across segment boundaries.

        A job is dispatchable once every producer it references has finished
        *dispatching* (its result tensor exists; device compute may still be
        in flight — the device's one stream orders the consumer behind it).
        Control jobs run on
        the host as their inputs complete, orco-style: the dispatch loop drains
        whichever future finishes first rather than a whole segment.
        """
        master = self._master
        t_run0 = time.perf_counter()
        futures: dict[str, tuple[concurrent.futures.Future, Worker, int]] = {}
        done: set[str] = set()          # device jobs with completed dispatch
        host_done: set[str] = set()     # executed control jobs
        seg_reports: dict[int, SegmentReport] = {}
        seg_t0: dict[int, float] = {}
        worker_time: dict[int, dict[int, float]] = {}

        def sreport_for(seg: int) -> SegmentReport:
            if seg not in seg_reports:
                seg_reports[seg] = SegmentReport(index=seg)
                seg_t0[seg] = time.perf_counter()
            return seg_reports[seg]

        def harvest() -> None:
            for name, (fut, worker, seg) in list(futures.items()):
                if name in done or not fut.done():
                    continue
                _, elapsed = fut.result()
                wt = worker_time.setdefault(seg, {})
                wt[worker.wid] = wt.get(worker.wid, 0.0) + elapsed * worker.slowdown
                with self._lock:
                    self._inflight[worker.wid] = max(
                        0, self._inflight.get(worker.wid, 0) - 1)
                done.add(name)
                sreport_for(seg).wall_time = time.perf_counter() - seg_t0[seg]

        while True:
            harvest()
            finished = done | host_done
            pending = [j for j in graph.jobs()
                       if j.name not in futures and j.name not in host_done]
            waiting = [f for n, (f, _, _) in futures.items() if n not in done]
            if not pending:
                # drain before declaring done: only harvest() observes
                # results, so a future completing between harvest() and
                # here must not be skipped (it may hold an exception)
                if not waiting:
                    break
                concurrent.futures.wait(
                    waiting, return_when=concurrent.futures.FIRST_COMPLETED)
                continue
            ready = [j for j in pending
                     if all(d in finished for d in j.deps())]
            if not ready:
                if not waiting:  # pragma: no cover - valid graphs always progress
                    raise GraphValidationError(
                        f"dataflow deadlock: {[j.name for j in pending]} not ready")
                concurrent.futures.wait(
                    waiting, return_when=concurrent.futures.FIRST_COMPLETED)
                continue
            controls = [j for j in ready
                        if self.registry[j.fn].kind == FunctionKind.CONTROL]
            device_jobs = [j for j in ready if j not in controls]
            if device_jobs:
                with self._lock:
                    loads = dict(self._inflight)
                    placements = master.plan_segment(device_jobs, self.store,
                                                     loads=loads)
                for p in placements:
                    sr = sreport_for(p.job.segment)
                    if p.co_scheduled_with:
                        sr.co_scheduled.append((p.job.name,) + p.co_scheduled_with)
                    worker = self._maybe_speculate(p, sr)
                    with self._lock:
                        self._inflight[worker.wid] = \
                            self._inflight.get(worker.wid, 0) + 1
                    fut = self._queue(worker.wid).submit(
                        self._execute_on, p.job, worker, graph, sr)
                    futures[p.job.name] = (fut, worker, p.job.segment)
            for job in sorted(controls, key=lambda j: (j.segment, j.name)):
                sr = sreport_for(job.segment)
                worker = (self.cluster.alive_workers()
                          or [self.cluster.spawn_worker()])[0]
                ctx = ControlContext(graph, job.segment)
                _, elapsed = self._execute_on(job, worker, graph, sr, ctx)
                report.dynamic_jobs_added += len(ctx.added)
                wt = worker_time.setdefault(job.segment, {})
                wt[worker.wid] = wt.get(worker.wid, 0.0) + elapsed * worker.slowdown
                host_done.add(job.name)
                sr.wall_time = time.perf_counter() - seg_t0[job.segment]

        # final barrier: everything must be device-complete before results
        # are handed back
        self._segment_barrier(done | host_done)
        for seg, sr in sorted(seg_reports.items()):
            sr.jobs = (graph.segments[seg].names()
                       if seg < len(graph.segments) else [])
            sr.sim_makespan = max(worker_time.get(seg, {}).values(), default=0.0)
            report.segments.append(sr)
        if release_consumed:
            for seg in range(len(graph.segments)):
                self._release_dead_results(graph, seg)

    def _release_dead_results(self, graph: JobGraph, done_segment: int) -> None:
        for name, rec in self.store.records.items():
            if rec.data is None:
                continue
            consumers = graph.consumers(name)
            if consumers and all(c.segment <= done_segment and
                                 c.name in self.store.records for c in consumers):
                self.store.release(name)


# ---------------------------------------------------------------------------
# SPMD (fused) executor — beyond-paper optimisation
# ---------------------------------------------------------------------------

#: iterations between the host's reads of a loop's condition
CHECK_EVERY = 16


def run_while_loop(body: Callable, cond: Callable, carry, max_iters: int):
    """``while n < max_iters and cond(carry): carry = body(carry); n += 1``
    without a device round trip per iteration.

    The loop runs in blocks of :data:`CHECK_EVERY` iterations.  Within a
    block each iteration queues ``cond(carry)`` on the device and then
    ``body(carry)``, and the host reads the block's conditions once, at
    its end (one synchronise).  If all held, the block stands.  Otherwise
    the loop ends at the first that did not, with the carry that block
    held there: every iteration before it saw the same carries as the
    while loop, so the result, the final carry and the iteration count,
    is exactly the while loop's.  The cost is one condition op per
    iteration, one synchronise per block, the block's carries kept alive
    until its check, and at most one block of work past the last active
    iteration.  ``body`` must not modify its argument in place; ``cond``
    returns a 0-d bool tensor.  Returns ``(carry, n_iters)``."""
    n = 0
    while n < max_iters:
        carries, conds = [], []
        for _ in range(min(CHECK_EVERY, max_iters - n)):
            carries.append(carry)
            conds.append(cond(carry))
            carry = body(carry)
        held = torch.stack(conds).tolist()
        if not all(held):
            first = held.index(False)
            return carries[first], n + first
        n += len(held)
    return carry, n


@dataclasses.dataclass
class IterativeSpec:
    """A self-re-enqueueing segment group (the paper's dynamic-job loop),
    declared explicitly so it can be fused into one device-resident loop.

    ``body``  — f(carry) -> carry, the fused body of the repeated segments
    ``cond``  — f(carry) -> 0-d bool tensor
    ``max_iters`` — safety bound (the paper requires a *finite* number of
                    dynamic additions)
    """

    body: Callable
    cond: Callable
    max_iters: int = 10_000


class SpmdExecutor(BaseExecutor):
    """Fuse segments into batched computations on one device.

    Same-function chunkwise job groups in a segment are stacked over the
    chunk axis and executed as ONE ``torch.func.vmap`` call over the
    chunks.  On one device there is no mesh to shard over and nothing to
    gather, so ``no_send_back`` and sent-back results alike stay where they
    were computed.
    """

    def __init__(self, device, registry: FunctionRegistry):
        self.device = indexed_device(device)
        self.registry = registry
        self.results: dict[str, Any] = {}     # job name -> stacked tensor
        self._fused: dict[Any, Callable] = {}

    # -- execution ----------------------------------------------------------------
    def _stacked_input(self, job: Job, graph: JobGraph) -> list[Any]:
        arrs = []
        if job.name in graph.bound_inputs:
            cd = graph.bound_inputs[job.name]
            arrs.append(torch.stack(cd.arrays()).to(self.device))
        for ref in job.inputs:
            if ref.job not in self.results:
                raise GraphValidationError(f"{job.name}: missing result {ref.job}")
            val = self.results[ref.job]
            if not ref.whole:
                val = val[ref.lo:ref.hi]
            arrs.append(val)
        return arrs

    def _fused_chunkwise(self, fid) -> Callable:
        if fid not in self._fused:
            self._fused[fid] = torch.func.vmap(self.registry[fid].fn)
        return self._fused[fid]

    def run(self, graph: JobGraph) -> tuple[dict[str, Any], ExecutionReport]:
        report = ExecutionReport(mode="spmd")
        for seg_idx, segment in enumerate(graph.segments):
            sreport = SegmentReport(index=seg_idx, jobs=list(segment.names()))
            t0 = time.perf_counter()
            n_dynamic_before = graph.n_jobs()
            # group same-function chunkwise jobs (worker co-scheduling,
            # generalised: ONE batched call executes the whole group)
            groups: dict[Any, list[Job]] = {}
            singles: list[Job] = []
            for job in segment.jobs:
                rf = self.registry[job.fn]
                if rf.kind == FunctionKind.CHUNKWISE:
                    groups.setdefault(job.fn, []).append(job)
                else:
                    singles.append(job)
            for fid, jobs in groups.items():
                if len(jobs) > 1:
                    sreport.co_scheduled.append(tuple(j.name for j in jobs))
                ins = [self._stacked_input(j, graph) for j in jobs]
                counts = [i[0].shape[0] for i in ins]
                stacked = [torch.cat([i[k] for i in ins], dim=0)
                           for k in range(len(ins[0]))]
                out = self._fused_chunkwise(fid)(*stacked)
                # split the fused result back to per-job results
                off = 0
                for j, c in zip(jobs, counts):
                    self.results[j.name] = out[off:off + c]
                    off += c
            for job in singles:
                rf = self.registry[job.fn]
                ins = self._stacked_input(job, graph)
                if rf.kind == FunctionKind.WHOLE:
                    out = rf.fn(*[ChunkedData.from_arrays(list(a)) for a in ins])
                    self.results[job.name] = torch.stack(out.arrays())
                elif rf.kind == FunctionKind.CONTROL:
                    ctx = ControlContext(graph, seg_idx)
                    host_ins = [ChunkedData.from_arrays([x.cpu() for x in a])
                                for a in ins]
                    out = rf.fn(*host_ins, ctx)
                    self.results[job.name] = (
                        torch.stack(out.arrays()).to(self.device)
                        if out is not None and len(out)
                        else torch.zeros((0,), device=self.device))
                    for new_job, tgt in ctx.added:
                        graph.add_dynamic(new_job, tgt, current=seg_idx)
                else:  # pragma: no cover
                    raise GraphValidationError(f"unsupported kind {rf.kind}")
            report.dynamic_jobs_added += max(
                0, graph.n_jobs() - n_dynamic_before)
            sreport.jobs = list(segment.names())
            sreport.wall_time = time.perf_counter() - t0
            report.segments.append(sreport)
        return dict(self.results), report

    # -- iterative fusion (beyond-paper: dynamic-job loop -> one device loop) --
    def run_iterative(self, spec: IterativeSpec, carry):
        """Run a convergence loop without leaving the device per iteration.

        The paper expresses iteration by letting a control job re-enqueue the
        body segments; a host round trip per iteration is the price.  Here
        body and condition run as one host loop (:func:`run_while_loop`)
        that synchronises only every ``CHECK_EVERY`` iterations.  Returns
        ``(final carry, n_iters)``.
        """
        return run_while_loop(spec.body, spec.cond, carry, spec.max_iters)
