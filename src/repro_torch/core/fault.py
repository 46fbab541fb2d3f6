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
* :class:`ServeChaosInjector` — deterministic fault injection for the
  serving scheduler: device-group kills, slow steps and allocator
  pressure.
"""
from __future__ import annotations

import dataclasses

from .executor import LocalExecutor
from .registry import FunctionRegistry
from .scheduler import ResultStore, VirtualCluster

__all__ = ["FaultInjector", "Heartbeat", "ChaosLocalExecutor",
           "ServeChaosInjector"]


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

    Two modes:

    * **round-based** (default) — beats are reported by the executor after
      each job; ``tick`` advances one monitoring round and a worker silent
      for more than ``max_missed`` rounds is failed.
    * **store-backed** — pass a :class:`~repro_torch.core.store.JobStore`;
      real worker processes stamp wall-clock heartbeats into the store on a
      timer (``interval_s``) and ``tick``/``expired_wids`` compare against
      ``max_missed * interval_s`` of silence.  This is what replaces the
      explicit ``fail()`` protocol for the :class:`ProcessExecutor`.

    Registration itself counts as a beat: a replacement worker spawned
    mid-run is not killed on the next tick before it ran a single job.
    """

    def __init__(self, cluster: VirtualCluster, max_missed: int = 3, *,
                 store=None, interval_s: float = 1.0,
                 boot_grace_s: float = 10.0):
        self.cluster = cluster
        self.max_missed = max_missed
        self.store = store
        self.interval_s = interval_s
        # real processes take far longer to boot (interpreter + imports)
        # than one beat interval; a worker that never checked in only
        # expires after this grace
        self.boot_grace_s = boot_grace_s
        self.last_beat: dict[int, int] = {}
        self.round = 0

    def register(self, wid: int) -> None:
        """Record the registration-time beat for a newly spawned worker."""
        self.last_beat.setdefault(wid, self.round)

    def beat(self, wid: int) -> None:
        self.last_beat[wid] = self.round

    def expired_wids(self) -> list[int]:
        """Alive workers whose last beat is too old (does not fail them)."""
        if self.store is not None:
            expired = set(self.store.expired(
                self.max_missed * self.interval_s,
                boot_grace_s=self.boot_grace_s))
            return [w.wid for w in self.cluster.alive_workers()
                    if w.wid in expired]
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


class ServeChaosInjector:
    """Deterministic fault injection for the SERVING path (DESIGN.md §14) —
    the serve-layer sibling of :class:`FaultInjector`.  A
    ``ServeScheduler`` constructed with ``chaos=`` calls ``on_step`` at the
    top of every ``step()`` and consults the other hooks from its watchdog
    and group-failover machinery; without an injector none of those paths
    change.

    All step counts run on the scheduler's ``step_calls`` clock (every
    ``step()`` CALL, including idle ones — plans cannot stall with a
    drained batch).  Three plans, composable:

    * ``kill_group=(gid, after, down)`` — at call ``after`` device group
      ``gid`` is failed (``sched.fail_group``); ``group_healthy`` stays
      False for ``down`` further calls, then the next health probe rejoins
      the group.
    * ``slow=(after, n, extra_s)`` — calls ``[after, after+n)`` report an
      extra ``extra_s`` seconds of measured duration to the step watchdog.
      The delay is injected into the MEASUREMENT, not slept: runs stay
      fast and deterministic, and at the watchdog's granularity a wedged
      step is indistinguishable from a slow one anyway.  ``slow_gid``
      narrows it to one device group.
    * ``pressure=(gid, after, n, pages)`` — the injector holds up to
      ``pages`` pages of group ``gid``'s pool for ``n`` calls (an
      allocator-level load spike forcing deferred admission / preemption);
      held pages are released at the window end, or by ``fail_group``'s
      quarantine sweep if the group dies holding them.
    """

    def __init__(self, *, kill_group: tuple[int, int, int] | None = None,
                 slow: tuple[int, int, float] | None = None,
                 slow_gid: int | None = None,
                 pressure: tuple[int, int, int, int] | None = None):
        self.kill_group = kill_group
        self.slow = slow
        self.slow_gid = slow_gid
        self.pressure = pressure
        self._held: dict[int, list[int]] = {}   # gid -> held page ids
        self._pressure_fired = False
        self.n_kills = 0
        self.n_slow_steps = 0
        self.n_pressure_pages = 0

    # -- scheduler hooks -------------------------------------------------------
    def on_step(self, sched) -> None:
        """Apply due plans; called at the top of every scheduler step."""
        step = sched.step_calls
        if self.kill_group is not None:
            gid, after, _down = self.kill_group
            if step >= after and sched.groups[gid].healthy \
                    and not self.group_healthy(sched, gid):
                self.n_kills += 1
                sched.fail_group(gid, reason="chaos kill_group")
        if self.pressure is not None:
            gid, after, n, pages = self.pressure
            g = sched.groups[gid]
            if (step >= after and not self._pressure_fired and g.healthy
                    and g.allocator is not None):
                self._pressure_fired = True
                take = min(pages, g.allocator.n_free)
                if take > 0:
                    held = g.allocator.alloc(take)
                    if held is not None:
                        self._held[gid] = held
                        self.n_pressure_pages += len(held)
            if step >= after + n:
                self.release_pages(sched, gid=gid)

    def step_extra_s(self, sched, gid: int) -> float:
        """Measured-duration inflation the watchdog should add for this
        group on the current step."""
        if self.slow is None:
            return 0.0
        if self.slow_gid is not None and gid != self.slow_gid:
            return 0.0
        after, n, extra = self.slow
        if after <= sched.step_calls < after + n:
            self.n_slow_steps += 1
            return float(extra)
        return 0.0

    def group_healthy(self, sched, gid: int) -> bool:
        """Probe gate: is the injected group fault still active?"""
        if self.kill_group is None or gid != self.kill_group[0]:
            return True
        _gid, after, down = self.kill_group
        return not (after <= sched.step_calls < after + down)

    # -- held-page accounting --------------------------------------------------
    def held_pages(self, gid: int) -> list[int]:
        """Pages the injector currently holds in group ``gid``'s pool —
        invariant checks add these to the expected outstanding set."""
        return list(self._held.get(gid, []))

    def release_pages(self, sched, gid: int | None = None) -> int:
        """Release held pressure pages (one group, or all).  Called by the
        window end, by ``fail_group``'s quarantine sweep, and by drains
        before their final leak checks."""
        gids = [gid] if gid is not None else list(self._held)
        n = 0
        for g in gids:
            held = self._held.pop(g, None)
            if held:
                sched.groups[g].allocator.free(held)
                n += len(held)
        return n


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
