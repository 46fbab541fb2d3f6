"""Master/scheduler/worker runtime (paper §3.1) over PyTorch devices.

Paper roles:

* **master scheduler** (rank 0) — holds the complete algorithm description,
  *no job data*; selects available jobs and assigns them to schedulers.
* **schedulers** (rank > 0) — fixed set, alive for the whole run; own their
  jobs' results and know how to assemble results requested by other jobs;
  each drives a set of workers.
* **workers** — dynamically spawned, isolated, memoryless; execute assigned
  jobs; retain each job's I/O until the scheduler releases it; optionally
  keep results local (``no_send_back``).

Schedulers and workers are *placement targets*: each worker is pinned to a
``torch.device`` (the LocalExecutor).  "Spawning" a worker is allocating a
placement slot; "sending" data is a cross-device copy, which the placement
planner minimises (locality-aware scheduling = the paper's result-retention
idea).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .job import ChunkedData, GraphValidationError, Job, JobGraph

__all__ = [
    "Worker",
    "SchedulerProc",
    "VirtualCluster",
    "ResultRecord",
    "ResultStore",
    "Placement",
    "CostModelParams",
    "MasterScheduler",
]


# ---------------------------------------------------------------------------
# Cluster model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Worker:
    """An isolated, memoryless executor pinned to a device (paper §3.1)."""

    wid: int
    device: Any
    cores: int = 1
    scheduler: int = 1          # owning scheduler rank
    alive: bool = True
    slowdown: float = 1.0       # >1.0 simulates a straggler (tests/bench only)
    jobs_done: int = 0
    # retained job I/O (paper: kept until the scheduler signals release)
    retained: dict[str, ChunkedData] = dataclasses.field(default_factory=dict)

    def fail(self) -> None:
        """Simulate a worker loss: all retained results are gone (paper §3.1
        explicitly notes this drawback of no_send_back)."""
        self.alive = False
        self.retained.clear()


@dataclasses.dataclass
class SchedulerProc:
    """A scheduler process (rank > 0) — owns results sent back by its workers."""

    rank: int
    device: Any
    stored: dict[str, ChunkedData] = dataclasses.field(default_factory=dict)


def indexed_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with an index where it has one:
    ``torch.device("cuda") != torch.device("cuda:0")``, so a bare ``cuda``
    would count phantom moves against tensors on ``cuda:0``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class VirtualCluster:
    """Devices organised as schedulers + dynamically spawned workers."""

    def __init__(self, devices: Sequence[Any] | None = None, *,
                 n_schedulers: int = 1, cores_per_worker: int = 1,
                 max_workers: int | None = None):
        """``devices``: the placement targets (``torch.device`` or its
        string form); default every CUDA device.  Devices are kept in
        indexed form (``cuda:0``, never bare ``cuda``), so a device compares
        equal to ``tensor.device`` of a tensor that lives on it."""
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("VirtualCluster() places workers on CUDA "
                                   "devices and found none; pass devices="
                                   "[torch.device('cpu')] to run on the CPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = [indexed_device(d) for d in devices]
        if not self.devices:
            raise ValueError("need at least one device")
        if n_schedulers < 1:
            raise ValueError("need at least one scheduler")
        self.n_schedulers = n_schedulers
        self.cores_per_worker = cores_per_worker
        self.max_workers = max_workers if max_workers is not None else max(len(self.devices), 1)
        # master (rank 0) holds no data; schedulers rank 1..N own results.
        # Schedulers share devices round-robin with workers — they are host
        # threads here; data they "store" lives on their device.
        self.schedulers = [SchedulerProc(rank=r, device=self.devices[r % len(self.devices)])
                           for r in range(1, n_schedulers + 1)]
        self.workers: list[Worker] = []

    # -- paper: workers are spawned during runtime -----------------------------
    def spawn_worker(self, scheduler_rank: int | None = None) -> Worker:
        # dead workers release their slot — recovery must be able to spawn a
        # replacement even when the cluster was at capacity (DESIGN.md §6)
        if len(self.alive_workers()) >= self.max_workers:
            raise RuntimeError(f"cannot spawn more than {self.max_workers} workers")
        wid = len(self.workers)
        sched = scheduler_rank or (wid % self.n_schedulers) + 1
        w = Worker(wid=wid, device=self.devices[wid % len(self.devices)],
                   cores=self.cores_per_worker, scheduler=sched)
        self.workers.append(w)
        return w

    def alive_workers(self) -> list[Worker]:
        return [w for w in self.workers if w.alive]

    def scheduler(self, rank: int) -> SchedulerProc:
        return self.schedulers[rank - 1]


# ---------------------------------------------------------------------------
# Result ownership (paper §3.1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ResultRecord:
    job: str
    data: ChunkedData | None      # None ⇒ lost (worker failure) or released
    owner_worker: int | None      # set when no_send_back kept it on the worker
    owner_scheduler: int          # scheduler responsible for the job
    sent_back: bool               # False ⇒ lives only on the worker
    nbytes: int = 0

    @property
    def available(self) -> bool:
        return self.data is not None


class ResultStore:
    """Distributed result directory.

    The master never stores data (paper); this store records *where* each
    result lives (scheduler device or retained on a worker) plus the handle
    to the (device-resident) arrays.
    """

    def __init__(self, cluster: VirtualCluster):
        self.cluster = cluster
        self.records: dict[str, ResultRecord] = {}

    def put(self, job: Job, data: ChunkedData, worker: Worker) -> ResultRecord:
        if job.no_send_back:
            worker.retained[job.name] = data
            rec = ResultRecord(job=job.name, data=data, owner_worker=worker.wid,
                               owner_scheduler=worker.scheduler, sent_back=False,
                               nbytes=data.nbytes)
        else:
            sched = self.cluster.scheduler(worker.scheduler)
            sched.stored[job.name] = data
            rec = ResultRecord(job=job.name, data=data, owner_worker=None,
                               owner_scheduler=worker.scheduler, sent_back=True,
                               nbytes=data.nbytes)
        self.records[job.name] = rec
        return rec

    def get(self, name: str) -> ResultRecord:
        try:
            return self.records[name]
        except KeyError:
            raise GraphValidationError(f"no result recorded for job {name}") from None

    def invalidate_worker(self, wid: int) -> list[str]:
        """Worker loss: every not-sent-back result it retained is gone.
        Returns the names of lost results (to be re-computed, DESIGN.md §6)."""
        lost = []
        for rec in self.records.values():
            if rec.owner_worker == wid and not rec.sent_back and rec.data is not None:
                rec.data = None
                lost.append(rec.job)
        return lost

    def release(self, name: str) -> None:
        """Paper: scheduler signals the worker the data is no longer required."""
        rec = self.records.get(name)
        if rec is None:
            return
        if rec.owner_worker is not None:
            w = self.cluster.workers[rec.owner_worker]
            w.retained.pop(name, None)
        rec.data = None

    def location_device(self, name: str):
        rec = self.get(name)
        if rec.owner_worker is not None:
            return self.cluster.workers[rec.owner_worker].device
        return self.cluster.scheduler(rec.owner_scheduler).device


# ---------------------------------------------------------------------------
# Placement planning (master scheduler)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Placement:
    """Assignment of one job to a worker (+ declared parallel width)."""

    job: Job
    worker: Worker
    n_sequences: int              # how many parallel lanes the job gets
    co_scheduled_with: tuple[str, ...] = ()
    local_bytes: int = 0          # input bytes already resident on the worker
    moved_bytes: int = 0          # input bytes that must be transferred
    est_cost_s: float = 0.0       # cost-model estimate (strategy="cost" only)


@dataclasses.dataclass(frozen=True)
class CostModelParams:
    """Hardware constants for the cost-model placement strategy.

    The three terms are a roofline decomposition (compute / memory /
    interconnect), as in ``repro_torch.analysis.roofline``; use
    :meth:`from_hw` to derive them from one of its ``HW`` profiles (e.g.
    ``H100``).  The defaults are a conservative host-CPU profile so the
    model produces sane *relative* costs out of the box.
    """

    peak_flops: float = 100e9     # per worker
    mem_bw: float = 20e9          # B/s local (worker-resident) reads
    link_bw: float = 5e9          # B/s cross-worker transfers
    dispatch_s: float = 50e-6     # fixed per-job dispatch overhead

    @classmethod
    def from_hw(cls, hw) -> "CostModelParams":
        """Build from any object with ``peak_flops`` / ``hbm_bw`` /
        ``ici_bw`` attributes (duck-typed, so ``core`` never imports
        ``analysis``)."""
        return cls(peak_flops=hw.peak_flops, mem_bw=hw.hbm_bw,
                   link_bw=hw.ici_bw)


class MasterScheduler:
    """Rank-0 process: owns the JobGraph, computes placements, stores no data.

    Two selectable placement strategies:

    ``strategy="greedy"`` (default, paper-faithful):
      1. locality first — place a job where the most input bytes already live
         (generalises the paper's ``no_send_back`` retention),
      2. then least-loaded worker,
      3. co-schedule same-function jobs onto one worker while their combined
         thread demand fits its cores (paper §3.3's 2×2-threads-on-4-cores
         example).

    ``strategy="cost"``: per candidate worker estimate

        cost = moved_bytes / link_bw                     (transfer)
             + queue_depth * observed_fn_time            (queueing)
             + max(flops_hint / peak, in_bytes / mem_bw) (roofline compute)
               * worker.slowdown

      and place on the argmin.  ``flops_hint`` comes from ``Job.cost_hint``;
      observed per-function wall times are fed back by the executor through
      :meth:`observe` (EWMA), so the queue term sharpens as the run
      progresses.  Co-scheduling is honoured in both strategies.

    Workers are spawned on demand (paper: "dynamically created during
    runtime"), up to the cluster limit.
    """

    def __init__(self, graph: JobGraph, cluster: VirtualCluster, *,
                 strategy: str = "greedy",
                 cost_params: CostModelParams | None = None,
                 observed_fn_times: Mapping[Any, float] | None = None):
        if strategy not in ("greedy", "cost"):
            raise ValueError(f"unknown placement strategy {strategy!r}")
        self.graph = graph
        self.cluster = cluster
        self.strategy = strategy
        self.cost_params = cost_params or CostModelParams()
        # EWMA of observed wall time per function id (cost-model queue term),
        # seeded from prior measurements when there are some (the kernel
        # autotune cache, repro_torch.kernels.tuning) so the first placement
        # round prices queueing with observed times; runtime observations
        # keep refining it.
        self._fn_time: dict[Any, float] = dict(observed_fn_times or {})

    # -- runtime feedback (executor -> master) ---------------------------------
    def observe(self, fid, elapsed_s: float, alpha: float = 0.3) -> None:
        prev = self._fn_time.get(fid)
        self._fn_time[fid] = (elapsed_s if prev is None
                              else (1 - alpha) * prev + alpha * elapsed_s)

    def _est_fn_time(self, fid) -> float:
        if fid in self._fn_time:
            return self._fn_time[fid]
        times = list(self._fn_time.values())
        return float(np.mean(times)) if times else self.cost_params.dispatch_s

    def _est_job_cost(self, job: Job, worker: Worker, *, total_in: int,
                      local: int, queue_depth: int) -> float:
        p = self.cost_params
        moved = total_in - local
        transfer_s = moved / p.link_bw
        queue_s = queue_depth * self._est_fn_time(job.fn)
        compute_s = max(job.cost_hint / p.peak_flops,
                        total_in / p.mem_bw) * worker.slowdown
        return p.dispatch_s + transfer_s + queue_s + compute_s

    # -- helpers ---------------------------------------------------------------
    def _input_bytes_by_location(self, job: Job, store: ResultStore) -> dict[int | None, int]:
        """Map worker-id (or None = scheduler-resident) -> input bytes there."""
        by_loc: dict[int | None, int] = {}
        for ref in job.inputs:
            rec = store.records.get(ref.job)
            if rec is None or rec.data is None:
                continue
            sel = ref.select(rec.data)
            loc = rec.owner_worker if not rec.sent_back else None
            by_loc[loc] = by_loc.get(loc, 0) + sel.nbytes
        return by_loc

    def plan_segment(self, segment_jobs: Sequence[Job], store: ResultStore,
                     *, loads: Mapping[int, int] | None = None) -> list[Placement]:
        """Plan placements for every job of one parallel segment.

        This call is batched by design — callers should hand it ALL the jobs
        that become ready together (a whole segment, or a serving admission
        wave) rather than loop over singletons: one call amortises the ordering /
        co-scheduling bookkeeping and lets locality and load terms see the
        whole wave at once.

        Re-placement is legal: a job that was removed from the graph
        (``JobGraph.remove_job`` — serving-time GC or a preempted dynamic
        job returning to the master queue) may be re-spawned under the same
        name and planned again in a later wave; the planner holds no state
        keyed on job identity beyond the per-function EWMA, which is
        exactly what SHOULD carry over to the re-placed incarnation.
        """
        loads = dict(loads or {})
        placements: list[Placement] = []
        # deterministic order: jobs sorted by (fn, name) so same-fn jobs are
        # adjacent for co-scheduling
        order = sorted(segment_jobs, key=lambda j: (str(j.fn), j.name))
        cohab: dict[int, list[Placement]] = {}   # wid -> placements sharing it

        for job in order:
            # input-less jobs (serving admissions, source jobs) skip the
            # result-directory walk entirely — on a hot admission path this
            # is one dict scan per job per wave
            by_loc = (self._input_bytes_by_location(job, store)
                      if job.inputs else {})
            total_in = sum(by_loc.values())

            # try co-scheduling with an already-placed same-fn job
            placed = None
            want = job.n_threads if job.n_threads > 0 else self.cluster.cores_per_worker
            for wid, plist in cohab.items():
                w = self.cluster.workers[wid]
                if not w.alive:
                    continue
                used = sum(p.n_sequences for p in plist)
                if (all(p.job.fn == job.fn for p in plist)
                        and used + want <= w.cores):
                    placed = Placement(job=job, worker=w, n_sequences=want,
                                       co_scheduled_with=tuple(p.job.name for p in plist))
                    break

            if placed is None:
                if self.strategy == "cost":
                    w, est = self._choose_worker_cost(job, by_loc, total_in, loads)
                else:
                    w, est = self._choose_worker_greedy(job, by_loc, loads), 0.0
                n_seq = min(want, w.cores) if want > 0 else w.cores
                placed = Placement(job=job, worker=w, n_sequences=max(n_seq, 1),
                                   est_cost_s=est)

            local = by_loc.get(placed.worker.wid, 0)
            placed.local_bytes = local
            placed.moved_bytes = total_in - local
            loads[placed.worker.wid] = loads.get(placed.worker.wid, 0) + 1
            cohab.setdefault(placed.worker.wid, []).append(placed)
            placements.append(placed)

        # restore original job order for execution determinism
        idx = {j.name: i for i, j in enumerate(segment_jobs)}
        placements.sort(key=lambda p: idx[p.job.name])
        return placements

    # -- worker choice ---------------------------------------------------------
    def _choose_worker_greedy(self, job: Job, by_loc: Mapping[int | None, int],
                              loads: Mapping[int, int]) -> Worker:
        """Locality first, then least-loaded alive worker, else spawn."""
        best_wid, best_bytes = None, -1
        for loc, nb in sorted(by_loc.items(), key=lambda kv: (-kv[1], str(kv[0]))):
            if loc is None:
                continue
            w = self.cluster.workers[loc]
            if w.alive and nb > best_bytes:
                best_wid, best_bytes = loc, nb
        if best_wid is not None and best_bytes > 0:
            return self.cluster.workers[best_wid]
        alive = self.cluster.alive_workers()
        free = [w for w in alive if loads.get(w.wid, 0) == 0]
        if not free and len(alive) < self.cluster.max_workers:
            return self.cluster.spawn_worker()
        if alive:
            return min(alive, key=lambda w: (loads.get(w.wid, 0), w.wid))
        return self.cluster.spawn_worker()

    def _choose_worker_cost(self, job: Job, by_loc: Mapping[int | None, int],
                            total_in: int, loads: Mapping[int, int]
                            ) -> tuple[Worker, float]:
        """Argmin of the three-term cost estimate over all candidates.

        A to-be-spawned worker is one candidate (zero queue depth, zero
        locality) so the model decides between reusing a loaded worker with
        the data and paying the transfer to an idle one.
        """
        candidates: list[tuple[float, int, Worker | None]] = []
        for w in self.cluster.alive_workers():
            cost = self._est_job_cost(
                job, w, total_in=total_in, local=by_loc.get(w.wid, 0),
                queue_depth=loads.get(w.wid, 0))
            candidates.append((cost, w.wid, w))
        if len(self.cluster.alive_workers()) < self.cluster.max_workers:
            ghost = Worker(wid=len(self.cluster.workers), device=None)
            cost = self._est_job_cost(job, ghost, total_in=total_in, local=0,
                                      queue_depth=0)
            candidates.append((cost, ghost.wid, None))
        if not candidates:
            return self.cluster.spawn_worker(), 0.0
        cost, _, w = min(candidates, key=lambda c: (c[0], c[1]))
        if w is None:
            w = self.cluster.spawn_worker()
        return w, cost
