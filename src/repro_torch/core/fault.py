"""Fault tolerance & monitoring (the paper's §5 "future work", implemented).

The paper identifies the cost of its ``no_send_back`` optimisation: "in case
a worker has to be shut down, all results computed so far are lost and have
to be re-computed".  This module provides:

* :class:`FaultInjector` — deterministic worker-failure injection for tests
  and chaos runs (kill after N jobs / before segment K / explicit kill).
* :class:`Heartbeat` — liveness tracking; a worker that misses
  ``max_missed`` beats is declared dead and its retained results are
  invalidated (triggering lineage recovery in the LocalExecutor).
* :class:`ChaosLocalExecutor` — a LocalExecutor that consults the injector
  around every job execution, exercising the recovery path end-to-end.
"""
from __future__ import annotations

import dataclasses

from .executor import LocalExecutor
from .registry import FunctionRegistry
from .scheduler import ResultStore, VirtualCluster

__all__ = ["FaultInjector", "Heartbeat", "ChaosLocalExecutor"]


@dataclasses.dataclass
class FaultPlan:
    worker: int
    after_jobs: int | None = None      # kill once the worker finished N jobs
    before_segment: int | None = None  # kill when segment K is about to start


class FaultInjector:
    def __init__(self):
        self.plans: list[FaultPlan] = []
        self.killed: list[int] = []

    def kill_after_jobs(self, worker: int, n: int) -> "FaultInjector":
        self.plans.append(FaultPlan(worker=worker, after_jobs=n))
        return self

    def kill_before_segment(self, worker: int, segment: int) -> "FaultInjector":
        self.plans.append(FaultPlan(worker=worker, before_segment=segment))
        return self

    def maybe_kill(self, cluster: VirtualCluster, store: ResultStore, *,
                   segment: int | None = None) -> list[str]:
        """Apply due plans; returns names of results lost."""
        lost: list[str] = []
        for plan in list(self.plans):
            # match on wid, not list index: once replacement workers exist
            # the two can diverge and an index lookup kills the wrong worker
            w = next((x for x in cluster.workers if x.wid == plan.worker), None)
            if w is None:
                continue
            due = ((plan.after_jobs is not None and w.jobs_done >= plan.after_jobs)
                   or (plan.before_segment is not None and segment is not None
                       and segment >= plan.before_segment))
            if due and w.alive:
                w.fail()
                self.killed.append(w.wid)
                lost.extend(store.invalidate_worker(w.wid))
                self.plans.remove(plan)
        return lost


class Heartbeat:
    """Liveness monitor: a silent worker is declared dead after
    ``max_missed`` beats — *discovery*, not notification.

    Beats are reported by the executor after each job; ``tick`` advances one
    monitoring round and a worker silent for more than ``max_missed`` rounds
    is failed.  Registration itself counts as a beat: a replacement worker
    spawned mid-run is not killed on the next tick before it ran a single
    job.
    """

    def __init__(self, cluster: VirtualCluster, max_missed: int = 3):
        self.cluster = cluster
        self.max_missed = max_missed
        self.last_beat: dict[int, int] = {}
        self.round = 0

    def register(self, wid: int) -> None:
        """Record the registration-time beat for a newly spawned worker."""
        self.last_beat.setdefault(wid, self.round)

    def beat(self, wid: int) -> None:
        self.last_beat[wid] = self.round

    def expired_wids(self) -> list[int]:
        """Alive workers whose last beat is too old (does not fail them)."""
        out = []
        for w in self.cluster.alive_workers():
            self.register(w.wid)  # first sight == registration beat
            if self.round - self.last_beat[w.wid] > self.max_missed:
                out.append(w.wid)
        return out

    def tick(self, store: ResultStore) -> list[str]:
        """Advance one monitoring round; kill silent workers, return lost results."""
        self.round += 1
        lost: list[str] = []
        expired = set(self.expired_wids())
        for w in self.cluster.alive_workers():
            if w.wid in expired:
                w.fail()
                lost.extend(store.invalidate_worker(w.wid))
        return lost


class ChaosLocalExecutor(LocalExecutor):
    """LocalExecutor wired to a FaultInjector — used by tests to prove the
    recovery path (re-execution from the job graph) works.

    Works in every dispatch mode: with ``mode="pipelined"``/``"dataflow"``
    the kill check runs on the worker-queue threads, so it takes the
    executor's dispatch lock — a kill observed by one in-flight job is
    immediately visible to every other queue."""

    def __init__(self, cluster: VirtualCluster, registry: FunctionRegistry,
                 injector: FaultInjector, **kw):
        super().__init__(cluster, registry, **kw)
        self.injector = injector

    def _execute_on(self, job, worker, graph, report, ctx=None):
        with self._lock:
            self.injector.maybe_kill(self.cluster, self.store, segment=job.segment)
            if not worker.alive:
                # the scheduler would notice the dead worker and re-place
                alive = self.cluster.alive_workers()
                worker = (min(alive, key=lambda w: w.jobs_done) if alive
                          else self.cluster.spawn_worker())
            out = super()._execute_on(job, worker, graph, report, ctx)
            self.injector.maybe_kill(self.cluster, self.store, segment=job.segment)
            return out
