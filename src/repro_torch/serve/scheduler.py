"""Request-level serving scheduler: continuous batching over a
:class:`~repro_torch.serve.engine.Engine` or a
:class:`~repro_torch.serve.engine.PagedEngine` — the HyPar job model one
level up.

The port of the JAX package's ``ServeScheduler``.  Over the dense
``Engine`` a request's prompt is right-padded to its length bucket
(``buckets``) and prefilled into a free slot in one ``insert``; admission
checks only that a bucket and the slot's ``max_len`` fit.  Over the paged
engine admission is by free
pages of the shared pool (``reserve="lifetime"`` reserves a request's whole
span, ``reserve="demand"`` appends decode pages lazily and preempts on
exhaustion, resuming by chunked recompute); ``prefix_cache=True`` shares
cache-hit prompt prefixes copy-on-write; deadlines shed, expire and count
goodput.  All of it is host-side Python over numpy — the engine is the only
part that touches the device.

The decode fleet maps onto the paper's runtime roles: a *slot* is a worker
(its share of the KV pool a device-local retained result,
``no_send_back``), an admitted request is a *dynamic job* spawned by a
``control`` function (paper §3.3), and losing a slot's KV
(:meth:`ServeScheduler.fail_slot`) invalidates the retained result — the
request re-queues and re-prefills, lineage recovery.  Two modes share every
code path except placement:

* **direct** (``tracker=None``) — free slots are filled first-come-first-
  served;
* **hypar** (:class:`HyParRequestTracker`) — each admission wave goes
  through the core machinery: dynamic jobs added via
  :class:`~repro_torch.core.ControlContext`, placed by
  :class:`~repro_torch.core.MasterScheduler` (``greedy`` or ``cost``
  strategy, decode-time EWMA fed back via ``observe``), their generated
  tokens recorded in :class:`~repro_torch.core.ResultStore` as
  worker-retained results and released on delivery; with a
  :class:`~repro_torch.core.JobStore` suspended requests persist, so a
  restarted scheduler resumes them (:meth:`ServeScheduler.restore_suspended`).

Over a paged engine the slots and the page pool split into
``device_groups`` contiguous groups (:class:`DeviceGroup`), each with its
own allocator and prefix cache; admission routes each request to a group
by the cost model's score.  The robustness layer (DESIGN.md §14) is the
reference's: a step watchdog (``watchdog_budget_s``) evicts slots of an
over-budget step and drives a group that trips ``unhealthy_after`` times
into failover (:meth:`ServeScheduler.fail_group`), a quarantined group
rejoins through a health probe (:meth:`ServeScheduler.probe_group`) at a
backed-off interval, a per-request restart budget (``max_restarts``) ends
a request that faults evict too often as ``failed``, and a
:class:`~repro_torch.core.fault.ServeChaosInjector` (``chaos=``) injects
group kills, slow steps and allocator pressure.  Under a paged engine
with a device mesh (``PagedEngine(mesh=)``, DESIGN.md §13) group g is the
mesh's data row g: ``device_groups`` must equal the mesh's ``dp``, the
groups' slot and page ranges must be the rows' (``check_groups``), and a
group's probe reaches its row's devices.  Without a mesh every group
shares the engine's one device.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from collections import deque
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from ..core.job import ChunkedData, Job, JobGraph, ParallelSegment
from ..core.registry import ControlContext, FunctionKind, FunctionRegistry
from ..core.scheduler import (CostModelParams, MasterScheduler, ResultStore,
                              VirtualCluster)
from ..core.store import JobStore
from .engine import Engine, PagedEngine, SamplingParams, chunk_plan, sample
from .mesh import row_ranges
from .prefix import PrefixCache

__all__ = [
    "Request", "RequestResult", "RequestOutcome", "TERMINAL_OUTCOMES",
    "RequestQueue", "SlotState", "PageAllocator",
    "PrefixCache", "DeviceGroup", "CostModelParams", "ServeScheduler",
    "HyParRequestTracker", "DEFAULT_BUCKETS",
]

# prompt-length buckets of the dense engine: prompts are right-padded to
# the next bucket, so slot prefills run at a few shapes, not one a length
DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)


# ---------------------------------------------------------------------------
# Requests & results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray              # (S,) int32 prompt
    max_new: int                    # realised generation length
    arrival_s: float = 0.0          # scheduler-clock arrival time
    enc_embeds: Any = None          # encdec: (1, T, d) encoder input
    # declared generation cap: what ADMISSION must budget for.  Clients
    # declare a conservative cap (vLLM's max_tokens) while most requests
    # stop far short of it — full-lifetime reservation pays pages for the
    # cap, reserve-on-demand pays only for tokens actually generated.
    # None => the realised length is the cap.
    budget_new: int | None = None
    # deadlines (DESIGN.md §14), both relative to ``arrival_s``: the client
    # stops caring about the first token after ``ttft_deadline_s`` and about
    # the whole answer after ``total_deadline_s``.  None => no deadline.
    # Admission sheds requests whose EWMA-predicted TTFT already exceeds the
    # TTFT deadline; the loop retires requests past their total deadline
    # with the ``expired`` outcome.
    ttft_deadline_s: float | None = None
    total_deadline_s: float | None = None

    @property
    def declared_new(self) -> int:
        """Generation cap admission reserves/validates against (>= the
        realised ``max_new``)."""
        return (self.max_new if self.budget_new is None
                else max(self.max_new, self.budget_new))


@dataclasses.dataclass
class RequestResult:
    rid: int
    prompt_len: int
    tokens: list[int]               # generated ids (incl. the stop token)
    arrival_s: float
    token_s: list[float]            # completion time of each token
    finish_s: float

    @property
    def n_generated(self) -> int:
        return len(self.tokens)

    @property
    def ttft_s(self) -> float:
        """Time to first token, measured from arrival (queueing included)."""
        return self.token_s[0] - self.arrival_s

    @property
    def step_latencies_s(self) -> list[float]:
        """Inter-token latencies after the first token."""
        return [b - a for a, b in zip(self.token_s, self.token_s[1:])]


#: the closed set of terminal request outcomes (DESIGN.md §14).  Every
#: request that enters the scheduler ends in EXACTLY one of these —
#: ``ServeScheduler._record_outcome`` raises on a second recording, so the
#: no-request-left-behind guarantee is structural, not best-effort.
TERMINAL_OUTCOMES = ("completed", "shed_queue", "shed_deadline",
                     "expired", "failed")


@dataclasses.dataclass(frozen=True)
class RequestOutcome:
    """One request's terminal fate on the scheduler clock.

    * ``completed`` — finished normally; its :class:`RequestResult` is in
      ``sched.results``,
    * ``shed_queue`` — refused at admission for capacity (full queue, or a
      request that can never fit the engine; ``detail`` says which),
    * ``shed_deadline`` — refused because its TTFT deadline was already
      unmeetable (EWMA load prediction, or the deadline passed while
      queued),
    * ``expired`` — admitted but its total deadline passed before it
      finished; partial work is discarded,
    * ``failed`` — evicted by faults more times than ``max_restarts``
      allows.
    """

    rid: int
    outcome: str
    finish_s: float
    detail: str = ""


class RequestQueue:
    """FIFO admission queue.  ``max_pending`` is the admission-control knob:
    a full queue sheds the request (``submit`` returns False) instead of
    growing without bound — the caller decides whether to retry."""

    def __init__(self, max_pending: int | None = None):
        self.max_pending = max_pending
        self._q: deque[Request] = deque()
        self._next_rid = 0
        self.n_submitted = 0
        # typed shed counters (DESIGN.md §14): WHY a request was refused,
        # not just that one was — `n_rejected` stays as their sum
        self.shed_queue_full = 0
        self.shed_never_fits = 0
        self.shed_deadline = 0

    @property
    def n_rejected(self) -> int:
        """Total shed requests — the sum of the typed counters."""
        return (self.shed_queue_full + self.shed_never_fits
                + self.shed_deadline)

    def reset_shed(self) -> None:
        self.shed_queue_full = 0
        self.shed_never_fits = 0
        self.shed_deadline = 0

    def next_rid(self) -> int:
        rid, self._next_rid = self._next_rid, self._next_rid + 1
        return rid

    def submit(self, req: Request) -> bool:
        if self.max_pending is not None and len(self._q) >= self.max_pending:
            self.shed_queue_full += 1
            return False
        self._q.append(req)
        self.n_submitted += 1
        return True

    def push_front(self, req: Request) -> None:
        """Re-queue a request whose pages were taken (preemption, or an
        admission that must wait); it bypasses admission — the request was
        already admitted once."""
        self._q.appendleft(req)

    def pop(self) -> Request | None:
        return self._q.popleft() if self._q else None

    def __len__(self) -> int:
        return len(self._q)


# ---------------------------------------------------------------------------
# Per-slot host-side state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SlotState:
    """Host-side mirror of one engine slot: position, remaining budget and
    stop status — the per-slot bookkeeping the engine's per-slot cache
    lengths are kept in sync with.  Under a paged engine the slot also
    tracks its page allocation and the chunks of an in-progress prefill."""

    slot: int
    request: Request | None = None
    pos: int = 0                    # tokens in the slot's cache
    budget: int = 0                 # generated tokens still allowed
    next_token: int = 0             # fed to the next decode step
    finished: bool = False
    tokens: list[int] = dataclasses.field(default_factory=list)
    token_s: list[float] = dataclasses.field(default_factory=list)
    page_ids: list[int] = dataclasses.field(default_factory=list)
    # chunked prefill in flight: remaining (start, bucket_len, valid) chunks
    pending_chunks: list[tuple[int, int, int]] = \
        dataclasses.field(default_factory=list)
    # reserve-on-demand bookkeeping: admission order (LIFO preemption
    # tiebreak), the token stream the in-flight prefill is replaying
    # (prompt, or prompt + retained tokens on a resume), the suspended
    # record being resumed, and how many tokens were already generated when
    # the request was (re)admitted (resume-progress floor)
    admit_seq: int = 0
    prefill_tokens: np.ndarray | None = None
    resume: "_Suspended | None" = None
    resume_base: int = 0

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def prefilling(self) -> bool:
        return self.request is not None and bool(self.pending_chunks)


@dataclasses.dataclass
class _Suspended:
    """Host-side remains of a preempted request: the generated tokens (and
    their timestamps — TTFT was already measured) survive the loss of the
    device-side KV state, which is rebuilt on resume by chunked
    re-prefill of prompt + retained tokens (recompute, not swap)."""

    tokens: list[int]
    token_s: list[float]
    n_preempts: int = 1


class PageAllocator:
    """Host-side free list + per-page reference counts over the shared KV
    page pool.

    Page 0 is the engine's reserved trash page and is never handed out.
    Pages come out of ``alloc`` exclusively owned (refcount 1) and may gain
    further read-only references via :meth:`share` — prefix-cache hits map
    extra slots (and the cache itself) onto one physical page.  The paged
    write paths' invariant is therefore **writable iff refcount == 1**: a
    write into a shared page must copy-on-write first (the scheduler's
    job).  ``free`` releases one reference per listed page; a page returns
    to the free list only when its LAST reference drops, so for unshared
    pages the semantics are exactly the old exclusive ones (including the
    double-free error).  ``alloc`` returns ``None`` when the pool cannot
    cover the request — the admission signal: the request stays queued
    until retirements free pages.

    ``watermark`` free pages are held back from *admission* allocations
    (:meth:`admit`): under reserve-on-demand the pool's slack is what decode
    appends draw from, and admitting into the last free pages converts every
    subsequent page-boundary crossing into a preemption.  Appends themselves
    (``alloc``) may dip below the watermark — they are the demand the
    headroom exists for.
    """

    def __init__(self, num_pages: int, *, n_reserved: int = 1,
                 watermark: int = 0):
        if num_pages <= n_reserved:
            raise ValueError(f"pool of {num_pages} pages has no usable pages "
                             f"beyond the {n_reserved} reserved")
        if watermark < 0:
            raise ValueError(f"watermark {watermark} must be >= 0")
        self.num_pages = num_pages
        self.n_reserved = n_reserved
        self.watermark = watermark
        # stack popped from the end => ascending page ids first
        self._free = list(range(num_pages - 1, n_reserved - 1, -1))
        self._ref: dict[int, int] = {}   # outstanding page -> refcount >= 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_outstanding(self) -> int:
        return len(self._ref)

    @property
    def outstanding(self) -> frozenset[int]:
        """Snapshot of the pages currently owned by at least one holder
        (invariant checks: must equal the union of every slot's
        ``page_ids`` and the prefix cache's held pages)."""
        return frozenset(self._ref)

    def refcount(self, page: int) -> int:
        """References on ``page`` (0 => free / never allocated)."""
        return self._ref.get(int(page), 0)

    def writable(self, page: int) -> bool:
        """A page may be written in place only while exactly one reference
        exists — any write into a shared page must copy-on-write first."""
        return self._ref.get(int(page), 0) == 1

    def alloc(self, n: int) -> list[int] | None:
        if n <= 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def admit(self, n: int) -> list[int] | None:
        """Admission-path allocation: refuses to leave fewer than
        ``watermark`` pages free.  Decode appends use plain :meth:`alloc`."""
        if len(self._free) - n < self.watermark:
            return None
        return self.alloc(n)

    def share(self, pages: Iterable[int]) -> None:
        """Take one additional (read-only) reference on each outstanding
        page — a prefix-cache hit mapping a new slot onto shared pages, or
        the cache itself retaining a retired request's prefix."""
        pages = [int(p) for p in pages]
        missing = [p for p in pages if p not in self._ref]
        if missing:
            raise ValueError(f"cannot share unallocated page(s) "
                             f"{sorted(set(missing))}")
        for p in pages:
            self._ref[p] += 1

    def free(self, pages: Iterable[int]) -> None:
        """Release one reference per listed page (a page listed twice
        releases two).  The WHOLE batch is validated before any mutation:
        an over-free (more releases than references — double free or
        foreign page) raises with the allocator untouched, instead of
        half-freed mid-loop with the conservation invariant broken for the
        rest of the run."""
        pages = [int(p) for p in pages]
        counts = collections.Counter(pages)
        bad = sorted(p for p, c in counts.items()
                     if self._ref.get(p, 0) < c)
        if bad:
            raise ValueError(f"page(s) {bad} have fewer references than "
                             f"frees requested (double free or foreign "
                             f"page); nothing was freed")
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)


@dataclasses.dataclass
class DeviceGroup:
    """One data-parallel partition of the serving engine (DESIGN.md §13).

    A group owns a contiguous range of batch slots and a private, contiguous
    range of the page pool behind its own :class:`PageAllocator` (and its
    own :class:`PrefixCache`) — allocation, sharing, COW and preemption
    never cross a group boundary, so every per-group invariant is exactly
    the single-allocator invariant.  The allocator's ``[n_reserved,
    num_pages)`` free range doubles as the group's page range; the
    engine-global trash page 0 is shared by all groups (it is never
    allocator-owned, so it cannot carry a cross-group reference).  A dense
    engine's one group has no allocator.

    ``ewma_step_s`` is the group's decode-time EWMA — the queue-depth term
    of the admission router's cost score.
    """

    gid: int
    slot_ids: tuple[int, ...]
    allocator: PageAllocator | None
    prefix: PrefixCache | None = None
    ewma_step_s: float = 0.0
    occupied_slot_steps: int = 0
    # failover state machine (DESIGN.md §14): healthy -> unhealthy on
    # injection or ``unhealthy_after`` watchdog trips (in-flight requests
    # evicted, pages quarantined at zero outstanding) -> healthy again once
    # a probe passes.  ``down_step`` is the scheduler-call stamp the probe
    # interval counts from.
    healthy: bool = True
    watchdog_trips: int = 0
    down_step: int = 0
    # rejoin backoff: the probe interval for this group is
    # ``probe_interval_steps * probe_backoff``.  The multiplier doubles
    # (capped at ``rejoin_backoff_cap``) on every failed probe and on every
    # re-failure shortly after a rejoin, so a flapping group stops soaking
    # the scheduler in constant-cadence probe/evict churn; it resets once
    # the group fails fresh after a long stable stretch.
    probe_backoff: int = 1
    up_step: int = 0          # step_calls stamp of the last rejoin
    backoff_wall: float | None = None   # clock stamp of the last re-arm

    @property
    def page_lo(self) -> int:
        return self.allocator.n_reserved

    @property
    def page_hi(self) -> int:
        return self.allocator.num_pages

    def observe(self, per_slot_step_s: float, alpha: float = 0.3) -> None:
        """Fold one decode step's per-live-slot time into the EWMA."""
        if self.ewma_step_s == 0.0:
            self.ewma_step_s = per_slot_step_s
        else:
            self.ewma_step_s = ((1 - alpha) * self.ewma_step_s
                                + alpha * per_slot_step_s)


# ---------------------------------------------------------------------------
# HyPar integration
# ---------------------------------------------------------------------------


class HyParRequestTracker:
    """Runs each admitted request through the core job machinery.

    Slots are pre-spawned :class:`~repro_torch.core.Worker`\\ s (wid == slot
    at start); a request becomes a dynamic ``Job`` spawned by the
    registered ``serve.admit`` *control* function, placed by
    :class:`MasterScheduler` (so ``greedy``/``cost`` strategies pick the
    slot), its generated tokens recorded as a ``no_send_back``
    (worker-retained) result in :class:`ResultStore` and released on
    delivery.  A failed slot loses its retained results
    (``invalidate_worker``), its worker's cluster slot is freed and a
    replacement is spawned — the serving instance of the recovery
    contract.

    ``devices`` are the workers' placement targets; None means every CUDA
    device, as :class:`VirtualCluster`'s default, and raises without one
    (pass ``[torch.device("cpu")]`` on the CPU).  ``jobstore`` makes
    suspended requests durable (:meth:`persist_suspended`).
    """

    ADMIT_FN = "serve.admit"
    DECODE_FN = "serve.decode"

    #: key prefix for suspended-request rows in the durable job store —
    #: keeps serve recovery state apart from any other ``requests`` users
    #: sharing the same sqlite file (e.g. a ProcessExecutor run)
    STORE_PREFIX = "serve.suspended:"

    def __init__(self, n_slots: int, *, strategy: str = "greedy",
                 cost_params: CostModelParams | None = None,
                 devices: Sequence[Any] | None = None,
                 flops_per_token: float = 0.0,
                 registry: FunctionRegistry | None = None,
                 jobstore: JobStore | None = None):
        self.n_slots = n_slots
        self.cluster = VirtualCluster(devices, max_workers=n_slots)
        for _ in range(n_slots):
            self.cluster.spawn_worker()
        self.graph = JobGraph([ParallelSegment([])])
        self.store = ResultStore(self.cluster)
        self.master = MasterScheduler(self.graph, self.cluster,
                                      strategy=strategy,
                                      cost_params=cost_params)
        self.registry = registry or FunctionRegistry()
        self.registry.register(self.ADMIT_FN, self._admit_control,
                               kind=FunctionKind.CONTROL, name=self.ADMIT_FN)
        self.flops_per_token = flops_per_token
        self.slot_to_wid = {i: i for i in range(n_slots)}
        self.wid_to_slot = {i: i for i in range(n_slots)}
        self._job_of: dict[int, Job] = {}
        self._pending_jobs: list[Job] = []
        self.jobstore = jobstore
        self.n_recovered = 0
        self.n_preempted = 0

    # -- control function: dynamic job creation (paper §3.3) -------------------
    def _admit_control(self, inputs: ChunkedData,
                       ctx: ControlContext) -> ChunkedData:
        for job in self._pending_jobs:
            ctx.add_job(job, 0)     # current segment: decode starts now
        self._pending_jobs = []
        return inputs

    # -- scheduler hooks -------------------------------------------------------
    def place(self, req: Request, free_slots: Sequence[int]) -> int:
        """Choose the slot for one admitted request via MasterScheduler."""
        return self.place_batch([req], free_slots)[req.rid]

    def place_batch(self, reqs: Sequence[Request],
                    free_slots: Sequence[int], *,
                    slot_choices: dict[int, Sequence[int]] | None = None,
                    ) -> dict[int, int]:
        """Place a whole admission wave with ONE ``plan_segment`` call: the
        wave's jobs are created together, spawned through one control-fn
        call and planned as one segment batch, with ``loads`` marking every
        slot outside ``free_slots`` busy.  Returns ``{rid: slot}``.

        ``slot_choices`` (``{rid: allowed slots}``) restricts each request
        to a subset of ``free_slots`` — under device groups the admission
        router already charged a specific group's allocator for the
        request's pages, so the slot MUST come from that group.  The
        master's pick is kept when it lands inside the allowed set, else
        the fallback stays within it."""
        if len(reqs) > len(free_slots):
            raise ValueError(f"wave of {len(reqs)} requests exceeds "
                             f"{len(free_slots)} free slots")
        jobs = [Job(name=f"req{r.rid}", fn=self.DECODE_FN, n_threads=1,
                    no_send_back=True,
                    cost_hint=self.flops_per_token * r.max_new)
                for r in reqs]
        self._pending_jobs = list(jobs)
        ctx = ControlContext(self.graph, current_segment=0)
        self.registry[self.ADMIT_FN].fn(ChunkedData(), ctx)
        for j, seg in ctx.added:
            self.graph.add_dynamic(j, seg, current=0)

        free = set(free_slots)
        loads = {wid: (0 if slot in free else 1)
                 for slot, wid in self.slot_to_wid.items()}
        placements = self.master.plan_segment(jobs, self.store, loads=loads)
        assign: dict[int, int] = {}
        remaining = set(free_slots)
        for req, placement in zip(reqs, placements):
            allowed = remaining
            if slot_choices is not None and req.rid in slot_choices:
                allowed = set(slot_choices[req.rid]) & remaining
                if not allowed:
                    raise ValueError(f"request {req.rid}: no free slot left "
                                     f"in its device group")
            slot = self.wid_to_slot.get(placement.worker.wid)
            if slot not in allowed:
                # master picked a busy/taken/unmapped/foreign-group worker:
                # fall back to the first remaining allowed slot and keep
                # ITS worker binding — rebinding the picked worker here
                # would leave two slots mapped to one wid and a later
                # fail() would invalidate the busy slot's results
                slot = sorted(allowed)[0]
            remaining.discard(slot)
            assign[req.rid] = slot
            self._job_of[req.rid] = placement.job
        return assign

    def finish(self, req: Request, slot: int, tokens: np.ndarray) -> None:
        """Record the request's output as a worker-retained result."""
        job = self._job_of[req.rid]
        worker = self.cluster.workers[self.slot_to_wid[slot]]
        self.store.put(job, ChunkedData.from_arrays([np.asarray(tokens)]),
                       worker)
        worker.jobs_done += 1

    def retire(self, req: Request) -> None:
        """Result delivered: release the retained data, GC the dynamic job
        and drop any durable resume state — the request is over."""
        self.drop_suspended(req.rid)
        job = self._job_of.pop(req.rid, None)
        if job is None:
            return
        self.store.release(job.name)
        self.graph.remove_job(job.name)

    def abandon(self, rid: int) -> None:
        """The request ends WITHOUT a result (expired / shed after
        suspension): its dynamic job — if one is still placed — leaves the
        graph with nothing recorded, and its durable resume row is dropped.
        ``retire``'s no-result sibling."""
        self.drop_suspended(rid)
        job = self._job_of.pop(rid, None)
        if job is not None:
            self.graph.remove_job(job.name)

    # -- durable resume state --------------------------------------------------
    def persist_suspended(self, rid: int, tokens: Sequence[int],
                          token_s: Sequence[float],
                          n_preempts: int) -> None:
        """Write a suspended request's host-retained tokens to the durable
        job store.  The device KV is already gone (that is what suspension
        means); with this row even the *master's* host copy is expendable —
        a restarted serving process re-seeds its suspended table from the
        store and resumes by the usual chunked recompute."""
        if self.jobstore is None:
            return
        self.jobstore.put_request(
            f"{self.STORE_PREFIX}{rid}",
            {"tokens": np.asarray(tokens, np.int64),
             "token_s": np.asarray(token_s, np.float64),
             "n_preempts": np.asarray(n_preempts, np.int64)})

    def drop_suspended(self, rid: int) -> None:
        if self.jobstore is not None:
            self.jobstore.delete_request(f"{self.STORE_PREFIX}{rid}")

    def restore_suspended(self) -> dict[int, tuple[list[int], list[float], int]]:
        """Read every persisted suspended-request record back:
        ``{rid: (tokens, token_s, n_preempts)}``.  Rids are stable across a
        master restart when requests are resubmitted in the original order
        (``RequestQueue`` numbers from zero)."""
        if self.jobstore is None:
            return {}
        out: dict[int, tuple[list[int], list[float], int]] = {}
        for key, fields in self.jobstore.get_requests().items():
            if not key.startswith(self.STORE_PREFIX):
                continue
            rid = int(key[len(self.STORE_PREFIX):])
            out[rid] = (fields["tokens"].tolist(),
                        fields["token_s"].tolist(),
                        int(fields["n_preempts"].reshape(-1)[0]))
        return out

    def preempt(self, req: Request) -> None:
        """The request's pages were reclaimed: its dynamic job returns to
        the master queue.  No result was recorded yet (``finish`` runs at
        completion), so the job simply leaves the graph; when the request
        resumes, the next ``place_batch`` wave re-spawns and re-places it —
        the same re-queue path ``fail`` uses, minus the worker replacement
        (the worker is healthy; only its page budget was taken)."""
        job = self._job_of.pop(req.rid, None)
        if job is not None:
            self.graph.remove_job(job.name)
        self.n_preempted += 1

    def observe(self, step_s: float, n_live: int) -> None:
        """Feed per-request decode-step time into the cost model's EWMA."""
        if n_live > 0:
            self.master.observe(self.DECODE_FN, step_s / n_live)

    def fail(self, slot: int, *, rid: int | None = None) -> list[str]:
        """Worker failure: retained results lost, cluster slot freed, a
        replacement worker spawned and bound to the slot."""
        wid = self.slot_to_wid[slot]
        worker = self.cluster.workers[wid]
        worker.fail()
        lost = self.store.invalidate_worker(wid)
        if rid is not None:
            job = self._job_of.pop(rid, None)
            if job is not None:     # in-flight job dies with its worker
                self.graph.remove_job(job.name)
        del self.wid_to_slot[wid]
        repl = self.cluster.spawn_worker()
        self.slot_to_wid[slot] = repl.wid
        self.wid_to_slot[repl.wid] = slot
        self.n_recovered += 1
        return lost


# ---------------------------------------------------------------------------
# The scheduler
# ---------------------------------------------------------------------------


class ServeScheduler:
    """Continuous-batching loop over an :class:`Engine` or a
    :class:`PagedEngine`.

    Slot lifecycle: a free slot pulls the next admitted request and
    prefills it — over the dense engine in one ``insert`` of the prompt
    right-padded to its bucket (``buckets``, clamped to ``max_len``); over
    the paged engine chunk by chunk (one chunk per ``step()``, interleaved
    with decode) — then samples its first token; every ``step()`` decodes
    the whole live batch once; a slot whose request hit its budget or stop
    token is retired and immediately refillable.  All request-visible
    timing (arrival, TTFT, per-token) is measured on ``clock``.

    Two reservation disciplines of the paged engine (DESIGN.md §10):

    * ``reserve="lifetime"`` — a request reserves its full prompt+budget
      page span at admission and can never be preempted;
    * ``reserve="demand"`` — vLLM-style: admission reserves only the prompt
      span (plus one decode write), decode pages are appended lazily at
      page boundaries, and pool exhaustion preempts the lowest-priority
      running slot (``preempt_policy``: ``fewest`` generated tokens with
      LIFO tiebreak, or plain ``lifo``); the victim's generated tokens are
      retained host-side and the request resumes — queue front — by chunked
      re-prefill of prompt + retained tokens (recompute, not swap).
      ``admit_watermark`` holds back free pages from admissions as append
      headroom, and ``resume_floor`` (default: one page of tokens) keeps a
      resumed request from being re-preempted before it makes progress.

    ``prefix_cache=True`` (DESIGN.md §11) additionally maps cache-hit
    prompt prefixes onto shared pool pages — admission prefills only the
    remainder (at best one chunk), the allocator refcounts shared pages,
    and any write into one copy-on-writes first.

    ``tracker`` (a :class:`HyParRequestTracker`) places every admission
    wave through the core job machinery instead of filling free slots in
    order; placement changes only which slot a request occupies, never its
    tokens.

    ``device_groups > 1`` (paged engines, DESIGN.md §13) partitions the
    slots and the usable page range into contiguous groups; each request
    is routed to one group by the cost model's score (``cost_params``) and
    lives entirely inside it.  The robustness layer (DESIGN.md §14): a
    step watchdog (``watchdog_budget_s``) evicts the slots of an
    over-budget prefill chunk or decode wave back through recovery, and a
    group that trips ``unhealthy_after`` times fails over; an unhealthy
    group is probed every ``probe_interval_steps`` scheduler calls, times
    a backoff multiplier capped at ``rejoin_backoff_cap``; ``max_restarts``
    caps the fault evictions one request may take before it ends
    ``failed``; ``chaos`` (a
    :class:`~repro_torch.core.fault.ServeChaosInjector`) injects faults
    into all of these.

    Sampling at temperature > 0 draws from ``generator`` (a
    ``torch.Generator`` on the engine's device; one seeded with 0 is made
    when none is given).
    """

    def __init__(self, engine: Engine | PagedEngine, *,
                 sp: SamplingParams = SamplingParams(),
                 queue: RequestQueue | None = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 tracker: HyParRequestTracker | None = None,
                 generator: torch.Generator | None = None,
                 clock: Callable[[], float] = time.perf_counter,
                 reserve: str = "lifetime",
                 preempt_policy: str = "fewest",
                 admit_watermark: int = 0,
                 resume_floor: int | None = None,
                 pool_pages: int | None = None,
                 prefix_cache: bool = False,
                 prefix_admit: int = 1,
                 device_groups: int = 1,
                 cost_params: CostModelParams | None = None,
                 enforce_deadlines: bool = True,
                 watchdog_budget_s: float | None = None,
                 unhealthy_after: int = 3,
                 probe_interval_steps: int = 5,
                 rejoin_backoff_cap: int = 16,
                 max_restarts: int | None = None,
                 chaos: Any = None):
        if reserve not in ("lifetime", "demand"):
            raise ValueError(f"unknown reserve discipline {reserve!r}")
        if preempt_policy not in ("fewest", "lifo"):
            raise ValueError(f"unknown preempt policy {preempt_policy!r}")
        if watchdog_budget_s is not None and watchdog_budget_s <= 0:
            raise ValueError(f"watchdog_budget_s {watchdog_budget_s} must "
                             f"be positive (None disables the watchdog)")
        if unhealthy_after < 1:
            raise ValueError(f"unhealthy_after {unhealthy_after} must be "
                             f">= 1")
        if probe_interval_steps < 1:
            raise ValueError(f"probe_interval_steps {probe_interval_steps} "
                             f"must be >= 1")
        if rejoin_backoff_cap < 1:
            raise ValueError(f"rejoin_backoff_cap {rejoin_backoff_cap} must "
                             f"be >= 1 (1 disables the backoff)")
        if max_restarts is not None and max_restarts < 0:
            raise ValueError(f"max_restarts {max_restarts} must be >= 0 "
                             f"(None = unlimited)")
        if admit_watermark and reserve != "demand":
            # the watermark is decode-append headroom — a concept only
            # reserve-on-demand has.  Under lifetime reservation _fits
            # screens against the raw pool while admit() would hold pages
            # back, so a request could pass screening yet be deferred
            # forever: reject the combination instead of livelocking.
            raise ValueError("admit_watermark requires reserve='demand' "
                             "(lifetime reservation has no decode appends "
                             "to hold headroom for)")
        self.engine = engine
        self.sp = sp
        self.queue = queue if queue is not None else RequestQueue()
        # clamp oversized buckets to the cache size instead of dropping them:
        # a prompt whose next bucket exceeds max_len may still fit the cache
        # (prompt + budget <= max_len) and must stay placeable
        self.buckets = tuple(sorted({min(b, engine.max_len) for b in buckets
                                     if b > 0}))
        if not self.buckets:
            raise ValueError(f"no prompt bucket fits max_len={engine.max_len}")
        self.paged = isinstance(engine, PagedEngine)
        if reserve == "demand" and not self.paged:
            raise ValueError("reserve='demand' needs a PagedEngine — the "
                             "dense per-slot cache has nothing to append")
        self.reserve = reserve
        self.demand = reserve == "demand"
        self.preempt_policy = preempt_policy
        # resume-progress floor: a resumed request may not be preempted
        # again until it has generated this many NEW tokens — without it a
        # tight pool can starve one request with preempt/resume ping-pong.
        # One page of decode progress is the natural default: by then the
        # resume has at least paid for the page it appends.
        self.resume_floor = (resume_floor if resume_floor is not None
                             else (engine.page_size if self.paged else 0))
        if prefix_cache and not self.paged:
            raise ValueError("prefix_cache requires a PagedEngine — dense "
                             "per-slot caches have no pages to share")
        # device groups: slots and the usable page range [1, pool_pages)
        # partition into contiguous, as-even-as-possible runs (page 0 is
        # the trash page); each group gets a PRIVATE PageAllocator over its
        # run (num_pages/n_reserved double as the range bounds) and, when
        # enabled, its own prefix cache.  ``pool_pages`` restricts the
        # TOTAL usable pool below the engine's physical one — the
        # oversubscription knob.
        if device_groups < 1:
            raise ValueError(f"device_groups {device_groups} must be >= 1")
        if device_groups > 1 and not self.paged:
            raise ValueError("device_groups > 1 requires a PagedEngine — "
                             "group ownership partitions the page pool")
        if device_groups > engine.batch:
            raise ValueError(f"device_groups {device_groups} exceeds the "
                             f"{engine.batch} batch slots (every group needs "
                             f"at least one)")
        self.admit_watermark = admit_watermark
        self.groups: list[DeviceGroup] = []
        if self.paged:
            usable = (engine.num_pages if pool_pages is None
                      else min(pool_pages, engine.num_pages))
            for gid, (slots_g, pages_g) in enumerate(
                    row_ranges(engine.batch, usable, device_groups)):
                if not pages_g:
                    raise ValueError(f"pool of {usable} usable pages cannot "
                                     f"cover {device_groups} device groups "
                                     f"(group {gid} would own none)")
                alloc = PageAllocator(pages_g.stop, n_reserved=pages_g.start,
                                      watermark=admit_watermark)
                pref = (PrefixCache(engine.page_size,
                                    admit_after=prefix_admit)
                        if prefix_cache and engine.supports_prefix_cache
                        else None)
                self.groups.append(DeviceGroup(
                    gid=gid, slot_ids=tuple(slots_g), allocator=alloc,
                    prefix=pref))
            engine.check_groups([(g.slot_ids, g.page_lo, g.page_hi)
                                 for g in self.groups])
        else:
            self.groups.append(DeviceGroup(
                gid=0, slot_ids=tuple(range(engine.batch)), allocator=None))
        self._slot_group = {s: g for g in self.groups for s in g.slot_ids}
        self.cost_params = cost_params or CostModelParams()
        self.tracker = tracker
        self.clock = clock
        self._generator = generator
        self.slots = [SlotState(i) for i in range(engine.batch)]
        self.results: list[RequestResult] = []
        self.n_steps = 0
        self.occupied_slot_steps = 0
        # reserve-on-demand state: suspended (preempted) requests by rid,
        # admission sequence numbers, and the preemption counters
        self._suspended: dict[int, _Suspended] = {}
        self._admit_seq = 0
        self.n_preempted = 0
        self.n_admit_deferred = 0
        self.resume_tokens_recomputed = 0
        # prefix-cache counters
        self.n_prefix_lookups = 0
        self.n_prefix_hits = 0
        self.pages_shared = 0
        self.n_cow_copies = 0
        self.n_cache_insert_deferred = 0
        # robustness layer (DESIGN.md §14): terminal outcomes, deadline
        # enforcement, the step watchdog and group failover
        self.enforce_deadlines = enforce_deadlines
        self.watchdog_budget_s = watchdog_budget_s
        self.unhealthy_after = unhealthy_after
        self.probe_interval_steps = probe_interval_steps
        self.rejoin_backoff_cap = rejoin_backoff_cap
        self.max_restarts = max_restarts
        self.chaos = chaos
        self.outcomes: dict[int, RequestOutcome] = {}
        self._restarts: dict[int, int] = {}
        self.watchdog_trips = 0
        self.n_expired = 0
        self.n_failed = 0
        self.n_group_failovers = 0
        self.n_group_rejoins = 0
        # clock seconds unhealthy groups spent waiting for their next
        # probe — grows with the backoff multiplier when a group flaps
        self.rejoin_backoff_s = 0.0
        # tokens from completed requests that met every declared deadline —
        # the numerator of the goodput metric
        self.goodput_tokens = 0
        # monotone count of step() CALLS — unlike n_steps it advances even
        # when nothing decodes (queue waiting on an unhealthy group), so
        # probe scheduling and chaos plans cannot stall with the loop
        self.step_calls = 0
        # EWMAs behind deadline admission: wall time per decode step and the
        # interval between retirements (how fast slots free up)
        self._ewma_step_s = 0.0
        self._ewma_retire_s = 0.0
        self._last_retire_s: float | None = None

    @property
    def allocator(self) -> PageAllocator | None:
        """Single-group accessor.  With multiple device groups there is no
        one allocator — use ``self.groups[g].allocator``; this raises
        instead of silently returning group 0's."""
        if len(self.groups) == 1:
            return self.groups[0].allocator
        raise RuntimeError(f"{len(self.groups)} device groups — no single "
                           f"allocator; use sched.groups[g].allocator")

    @property
    def prefix(self) -> PrefixCache | None:
        """Single-group accessor; see :attr:`allocator`."""
        if len(self.groups) == 1:
            return self.groups[0].prefix
        raise RuntimeError(f"{len(self.groups)} device groups — no single "
                           f"prefix cache; use sched.groups[g].prefix")

    @property
    def prefix_cache_active(self) -> bool:
        return any(g.prefix is not None for g in self.groups)

    def restore_suspended(self) -> int:
        """Re-seed the suspended-request table from the tracker's durable
        job store (master restart).  Call after constructing the scheduler
        and BEFORE resubmitting: requests resubmitted in the original order
        get their original rids back, so a restored record turns their
        admission into a resume — chunked recompute of prompt + retained
        tokens instead of regenerating from scratch.  Returns the number of
        records restored.  No-op without a demand-mode tracker backed by a
        store."""
        if self.tracker is None or not self.demand:
            return 0
        n = 0
        for rid, (tokens, token_s, n_pre) in \
                self.tracker.restore_suspended().items():
            if rid in self._suspended or not tokens:
                continue
            self._suspended[rid] = _Suspended(tokens=tokens, token_s=token_s,
                                              n_preempts=n_pre)
            n += 1
        return n

    # -- submission ------------------------------------------------------------
    def submit(self, tokens, max_new: int, *, enc_embeds=None,
               arrival_s: float | None = None,
               budget_new: int | None = None,
               ttft_deadline_s: float | None = None,
               total_deadline_s: float | None = None) -> int | None:
        """Admit one request.  Returns its rid, or None when shed — the
        queue is full, the request can never fit the engine (prompt +
        declared budget vs ``max_len`` and the pool), or its TTFT deadline is already
        unmeetable under current load (``sched.outcomes[rid]`` says
        which)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        req = Request(rid=self.queue.next_rid(), tokens=tokens,
                      max_new=max_new, enc_embeds=enc_embeds,
                      budget_new=budget_new,
                      arrival_s=self.clock() if arrival_s is None
                      else arrival_s,
                      ttft_deadline_s=ttft_deadline_s,
                      total_deadline_s=total_deadline_s)
        return req.rid if self._admit(req) else None

    def _admit(self, req: Request) -> bool:
        """The one admission gate (``submit()`` and timed replay): the
        never-fits screen, deadline-aware load shedding, then the bounded
        queue.  Every refusal records its typed terminal outcome."""
        if not self._fits(req):
            self.queue.shed_never_fits += 1
            self._record_outcome(req.rid, "shed_queue", detail="never_fits")
            return False
        if self.enforce_deadlines and req.ttft_deadline_s is not None:
            if self.clock() - req.arrival_s > req.ttft_deadline_s:
                # certain lateness: the wait alone already blew the deadline,
                # no estimate involved
                self.queue.shed_deadline += 1
                self._record_outcome(req.rid, "shed_deadline",
                                     detail="TTFT deadline already passed")
                return False
            if (self._queue_ahead() > 0
                    and self._predicted_ttft_s(req) > req.ttft_deadline_s):
                # predicted lateness: only sheds when there is actual backlog.
                # An idle scheduler must admit even with a pessimistic EWMA —
                # the step EWMA is only updated by live decode waves, so an
                # idle system that shed on stale evidence (e.g. warmup steps
                # that paid one-time costs) would never run a step to correct it
                # and would shed every request forever.
                self.queue.shed_deadline += 1
                self._record_outcome(req.rid, "shed_deadline",
                                     detail="predicted TTFT over deadline")
                return False
        if not self.queue.submit(req):
            self._record_outcome(req.rid, "shed_queue", detail="queue_full")
            return False
        return True

    def _queue_ahead(self) -> int:
        """Requests a new admission would wait behind: queue depth plus
        itself, minus slots free on healthy groups right now."""
        free = sum(1 for g in self.groups if g.healthy
                   for s in g.slot_ids if self.slots[s].free)
        return max(len(self.queue) + 1 - free, 0)

    def _predicted_ttft_s(self, req: Request) -> float:
        """EWMA estimate of ``req``'s TTFT were it admitted now: time it
        has already waited, the queue draining ahead of it (one retirement
        frees one slot), and its own prefill span.  Zero-initialised EWMAs
        make this start permissive — shedding is LOAD-based and needs
        observed evidence, unlike the structural never-fits screen."""
        ahead = self._queue_ahead()
        if self.paged:
            n_chunks = -(-max(len(req.tokens), 1) // self.engine.chunk_len)
        else:
            n_chunks = 1
        return ((self.clock() - req.arrival_s)
                + ahead * self._ewma_retire_s
                + (n_chunks + 1) * self._ewma_step_s)

    def _record_outcome(self, rid: int, outcome: str,
                        detail: str = "") -> None:
        """Record a request's terminal outcome — exactly once.  A second
        recording raises: the no-request-left-behind guarantee is enforced
        structurally, not asserted after the fact."""
        if outcome not in TERMINAL_OUTCOMES:
            raise ValueError(f"unknown outcome {outcome!r} (want one of "
                             f"{TERMINAL_OUTCOMES})")
        prev = self.outcomes.get(rid)
        if prev is not None:
            raise RuntimeError(
                f"request {rid} reached a second terminal outcome "
                f"{outcome!r} after {prev.outcome!r}")
        self.outcomes[rid] = RequestOutcome(rid=rid, outcome=outcome,
                                            finish_s=self.clock(),
                                            detail=detail)

    def _terminate(self, req: Request, outcome: str,
                   detail: str = "") -> None:
        """Terminal path for a request that will never run again (expired /
        failed / shed after suspension): drop its resume state — host and
        durable — and its tracker job, bump the matching counter, record
        the outcome."""
        self._suspended.pop(req.rid, None)
        if self.tracker is not None:
            self.tracker.abandon(req.rid)
        if outcome == "expired":
            self.n_expired += 1
        elif outcome == "failed":
            self.n_failed += 1
        elif outcome == "shed_deadline":
            self.queue.shed_deadline += 1
        self._record_outcome(req.rid, outcome, detail=detail)

    def _fits(self, req: Request) -> bool:
        """Can this request ever be placed.  Dense: a prompt bucket exists
        and prompt + declared budget stay inside the per-slot cache.
        Paged: its declared-budget page reservation fits the per-slot
        table width and the pool (transient exhaustion is NOT a rejection
        — the request waits for retirements; this check is only the
        never-fits test)."""
        cap = req.declared_new
        if not self.paged:
            return (self._bucket_len(len(req.tokens)) is not None
                    and len(req.tokens) + cap <= self.engine.max_len)
        if len(req.tokens) + cap > self.engine.max_len:
            return False
        need = self.engine.pages_needed(len(req.tokens), cap)
        pool_need = need
        if self.demand:
            # livelock guard: a resume re-prefills up to prompt +
            # max_new - 1 tokens, whose padded chunk span can exceed the
            # lifetime reservation by up to one chunk bucket — the
            # request is only admissible if its worst-case resume (plus
            # the admission watermark) still fits the pool, or a
            # preempted request could be deferred forever
            need = max(need, self.engine.pages_needed(
                len(req.tokens) + max(cap - 1, 0), 1))
            pool_need = need + self.admit_watermark
        # a request lives entirely inside ONE device group's page range,
        # so the never-fits test is against the LARGEST group's capacity
        group_cap = max(g.allocator.num_pages - g.allocator.n_reserved
                        for g in self.groups)
        return need <= self.engine.max_pages and pool_need <= group_cap

    def _bucket_len(self, n: int) -> int | None:
        for b in self.buckets:
            if b >= n:
                return b
        return None

    # -- slot lifecycle --------------------------------------------------------
    def _sample(self, logits) -> np.ndarray:
        if self.sp.temperature > 0 and self._generator is None:
            self._generator = torch.Generator(
                device=self.engine.device).manual_seed(0)
        return sample(logits, self.sp, self._generator)

    def _insert(self, req: Request, slot: int) -> None:
        """Dense path: prefill the prompt, right-padded to its bucket, into
        the slot in one ``insert`` (with an encoder-decoder request's
        ``enc_embeds``) and sample the first token."""
        S = len(req.tokens)
        padded = np.zeros((1, self._bucket_len(S)), np.int32)
        padded[0, :S] = req.tokens
        if self.engine.cfg.family == "encdec":
            self.engine.ensure_batch(enc_len=req.enc_embeds.shape[1])
        else:
            self.engine.ensure_batch()
        logits = self.engine.insert(slot, padded, true_len=S,
                                    enc_embeds=req.enc_embeds)
        self._admit_seq += 1
        self.slots[slot].admit_seq = self._admit_seq
        self._first_token(self.slots[slot], req, logits)

    def _first_token(self, st: SlotState, req: Request, logits) -> None:
        """Prefill done (one-shot or final chunk): sample the request's
        first token — time-to-first-token is measured here."""
        tok = int(self._sample(logits)[0])
        now = self.clock()
        st.request, st.pos, st.budget = req, len(req.tokens), req.max_new
        st.tokens, st.token_s = [tok], [now]
        st.next_token, st.finished = tok, False
        st.pos += 1
        st.budget -= 1
        if st.budget <= 0 or (self.sp.stop_token >= 0
                              and tok == self.sp.stop_token):
            st.finished = True

    def _prefill_stream(self, req: Request) -> np.ndarray:
        """The token stream an admission would prefill: the prompt, or —
        resuming a preempted request — prompt + all-but-the-last retained
        token (the last was never fed to decode and becomes ``next_token``
        again once the state is rebuilt)."""
        sus = self._suspended.get(req.rid) if self.demand else None
        if sus is not None:
            return np.concatenate(
                [req.tokens, np.asarray(sus.tokens[:-1], np.int32)])
        return req.tokens

    def _shared_prefix(self, g: DeviceGroup, stream) -> list[int]:
        """Cache-hit pages of GROUP ``g``'s prefix cache usable for this
        prefill stream, floored to a CHUNK boundary strictly below the
        stream end.

        The floor is the bit-exactness contract: K/V values are
        per-position pure functions of the tokens (identical however the
        prefill was chunked), but a chunk's LOGITS depend on where the
        cache-block/self-block softmax split falls — so the final chunk,
        whose logits seed the first sampled token, must be the same chunk a
        full prefill would run.  Flooring the shared span to a multiple of
        ``chunk_len`` below the last chunk's start makes the hit plan an
        exact suffix of the no-cache plan.  A corollary: the serving paths
        never write into the shared span (prefill resumes at the floor,
        decode writes land past the stream end), so COW triggers are
        defensive enforcement of writable-iff-refcount==1, not a steady-
        state cost."""
        if g.prefix is None:
            return []
        chain = g.prefix.lookup(stream)
        if not chain:
            return []
        ps, C = self.engine.page_size, self.engine.chunk_len
        last_chunk = (len(stream) - 1) // C      # the reference plan's tail
        usable_chunks = min((len(chain) * ps) // C, last_chunk)
        return chain[:usable_chunks * (C // ps)]

    def _start_prefill(self, req: Request, slot: int, page_ids: list[int],
                       shared: list[int], stream: np.ndarray) -> None:
        """Paged path: record the chunk plan; chunks run one per ``step()``
        (interleaved with live-batch decode) via ``_advance_prefill``.

        ``shared`` pages (prefix-cache hit, admission already took the
        slot's references) cover the head of ``stream``; the chunk plan
        starts at the shared boundary, so a hit's prefill costs only the
        remainder — at best one chunk (the non-aligned tail).  A resumed
        request (preempted earlier, generated tokens retained in
        ``_suspended``) re-prefills prompt + all-but-the-last retained
        token through the same chunk path."""
        self.engine.ensure_batch()
        st = self.slots[slot]
        st.request, st.page_ids = req, list(shared) + list(page_ids)
        self._admit_seq += 1
        st.admit_seq = self._admit_seq
        sus = self._suspended.pop(req.rid, None) if self.demand else None
        st.resume = sus
        st.resume_base = len(sus.tokens) if sus else 0
        st.prefill_tokens = stream
        start = len(shared) * self.engine.page_size
        if sus:
            self.resume_tokens_recomputed += len(stream) - start
        if self._slot_group[slot].prefix is not None:
            self.n_prefix_lookups += 1
            if shared:
                self.n_prefix_hits += 1
                self.pages_shared += len(shared)
        st.pending_chunks = chunk_plan(len(stream),
                                       self.engine.chunk_len,
                                       self.engine.chunk_buckets,
                                       start=start)
        st.tokens, st.token_s, st.finished = [], [], False

    def _advance_prefill(self, st: SlotState) -> None:
        """Run the next chunk of a mid-prefill slot; on the final chunk,
        commit the slot's pages into the live page table and sample the
        first token (fresh request) or restore the retained generation state
        (resume — the final chunk's logits were already sampled once, before
        the preemption, so they are discarded)."""
        start, bucket, valid = st.pending_chunks.pop(0)
        toks = st.prefill_tokens
        ps = self.engine.page_size
        g = self._slot_group[st.slot]
        # writable-iff-refcount==1 enforcement: a chunk write spanning a
        # SHARED page (divergent prefill) must copy-on-write first.  With
        # chunk-floored sharing the plan starts past every shared page, so
        # this is defensive — it fires only if sharing was forged outside
        # the admission path
        first = start // ps
        last = min(-(-(start + bucket) // ps), len(st.page_ids))
        for pidx in range(first, last):
            if not g.allocator.writable(st.page_ids[pidx]):
                if not self._cow_page(st, pidx):
                    raise RuntimeError(
                        f"pool exhausted during copy-on-write of prefill "
                        f"chunk page {pidx} (slot {st.slot})")
        ck = np.zeros((1, bucket), np.int32)
        ck[0, :valid] = toks[start:start + valid]
        logits = self.engine.prefill_chunk(st.slot, ck, st.page_ids, start,
                                           valid)
        if not st.pending_chunks:
            self.engine.commit_slot(st.slot, st.page_ids)
            if g.prefix is not None:
                # cache every full page of the stream — read-only from here
                # on (decode writes land past the stream end)
                before = g.prefix.n_insert_deferred
                g.prefix.insert(toks, st.page_ids, g.allocator)
                self.n_cache_insert_deferred += (g.prefix.n_insert_deferred
                                                 - before)
            if st.resume is not None:
                self._finish_resume(st)
            else:
                self._first_token(st, st.request, logits)

    def _finish_resume(self, st: SlotState) -> None:
        """Final resume chunk done: the cache again holds prompt +
        generated[:-1], exactly the state at preemption.  Restore the
        host-side bookkeeping; the next decode step feeds the last retained
        token as if the preemption never happened."""
        sus, req = st.resume, st.request
        st.resume = None
        st.tokens = list(sus.tokens)
        st.token_s = list(sus.token_s)
        st.pos = len(req.tokens) + len(st.tokens)
        st.budget = req.max_new - len(st.tokens)
        st.next_token = st.tokens[-1]
        st.finished = False

    def _admission_pages(self, req: Request, stream) -> int:
        """Total pages the head request needs to be admitted (shared +
        private).  Lifetime: the full prompt + DECLARED budget reservation
        (it cannot know the realised length up front).  Demand: the
        (padded) prefill span of the stream (prompt + retained tokens) plus
        room for the first decode write — every admission is then
        guaranteed at least one token of progress before it can possibly
        self-preempt, which is what makes the preempt/resume loop
        terminate."""
        if not self.demand:
            return self.engine.pages_needed(len(req.tokens),
                                            req.declared_new)
        return self.engine.pages_needed(len(stream), 1)

    def _admit_pages(self, g: DeviceGroup, n: int) -> list[int] | None:
        """Admission allocation from GROUP ``g`` with prefix-cache fallback:
        when the free list cannot cover it, evict cache-only entries
        (deepest-first) and retry once."""
        pages = g.allocator.admit(n)
        if pages is None and g.prefix is not None:
            if g.prefix.evict_for(g.allocator, n + g.allocator.watermark):
                pages = g.allocator.admit(n)
        return pages

    def _alloc_pages(self, g: DeviceGroup, n: int) -> list[int] | None:
        """Decode-append / COW allocation from GROUP ``g`` (may dip below
        the watermark), with the same cache-eviction fallback."""
        pages = g.allocator.alloc(n)
        if pages is None and g.prefix is not None:
            if g.prefix.evict_for(g.allocator, n):
                pages = g.allocator.alloc(n)
        return pages

    def _route_order(self, groups: Sequence[DeviceGroup],
                     need: int) -> list[DeviceGroup]:
        """Cost-model admission routing across device groups (the paper's
        dynamic job placement at device-group granularity): groups whose
        free pages cover the request outright come first, then by
        queue-depth × decode-EWMA cost (busy slots × per-slot step time,
        seeded with the cost model's dispatch overhead until the EWMA
        warms), free pages breaking ties.  Gid last keeps the order
        deterministic."""
        def score(g: DeviceGroup):
            busy = sum(1 for s in g.slot_ids
                       if self.slots[s].request is not None)
            step_s = g.ewma_step_s or self.cost_params.dispatch_s
            n_free = g.allocator.n_free if g.allocator is not None else 0
            return (0 if n_free >= need else 1, busy * step_s, -n_free, g.gid)
        return sorted(groups, key=score)

    def _fill_free_slots(self) -> None:
        """Admit a wave: pull queued requests while slots (dense) or slots +
        pages (paged) allow, place the WHOLE wave through the tracker in one
        ``plan_segment`` call, then insert (dense) or begin chunked prefill
        (paged).  Paged admission is FIFO: when no group's pool can cover
        the head request's reservation, filling stops until retirements
        free pages (no smaller request overtakes — no starvation of long
        prompts).  Under reserve-on-demand an exhausted pool may instead
        preempt one running victim for the head request — never more than
        one, and only when the victim's pages actually cover the shortfall
        (anti-thrash guard).

        With multiple device groups, each head request is routed to a group
        by :meth:`_route_order`; its shared-prefix hit, page allocation and
        eventual slot all come from THAT group, so page ownership never
        crosses a group boundary."""
        # unhealthy groups are quarantined out of admission entirely: their
        # free slots don't exist until a probe rejoins them
        free_by_gid = {g.gid: ([s for s in g.slot_ids if self.slots[s].free]
                               if g.healthy else [])
                       for g in self.groups}
        all_free = [s for ss in free_by_gid.values() for s in ss]
        # wave entries: (req, group, reserved slot, pages, shared, stream)
        wave: list[tuple] = []
        while any(free_by_gid.values()) and len(self.queue):
            req = self.queue.pop()
            if not self._fits(req):      # raw queue.submit bypassed admission
                self.queue.shed_never_fits += 1
                self._record_outcome(req.rid, "shed_queue",
                                     detail="never_fits")
                continue
            if self._deadline_drop_queued(req):
                continue
            if not self.paged:
                g = self.groups[0]
                wave.append((req, g, free_by_gid[g.gid].pop(0),
                             None, [], None))
                continue
            stream = self._prefill_stream(req)
            need_total = self._admission_pages(req, stream)
            cands = self._route_order(
                [g for g in self.groups if free_by_gid[g.gid]], need_total)
            placed = False
            for g in cands:
                shared = self._shared_prefix(g, stream)
                if shared:
                    # the slot's references on its hit pages — taken BEFORE
                    # the private allocation, so eviction inside it cannot
                    # reclaim them out from under the admission
                    g.allocator.share(shared)
                pages = self._admit_pages(g, need_total - len(shared))
                if pages is not None:
                    wave.append((req, g, free_by_gid[g.gid].pop(0),
                                 pages, shared, stream))
                    placed = True
                    break
                if shared:               # release the hit refs taken above
                    g.allocator.free(shared)
            if not placed and self.demand and req.rid in self._suspended:
                # only a RESUME may preempt to admit: it already earned
                # its place once and sits at the queue front, so letting
                # it displace a lesser-progressed runner prevents
                # starvation — whereas fresh arrivals preempting grown
                # runners is the recompute-thrash spiral (they wait for
                # retirements instead, like any FIFO admission).  One
                # victim, in the best-scored group only (anti-thrash).
                g = cands[0]
                shared = self._shared_prefix(g, stream)
                if shared:
                    g.allocator.share(shared)
                need = need_total - len(shared)
                # deadline guard: a resume that cannot meet its own total
                # deadline anyway may not displace an on-track runner —
                # trading a request that will count for one that won't
                victim = self._choose_victim(
                    g, shortfall=need + self.admit_watermark
                    - g.allocator.n_free,
                    spare_on_track=self._hopeless(req))
                if victim is not None:
                    self._preempt(victim)
                    pages = self._admit_pages(g, need)
                    if pages is not None:
                        wave.append((req, g, free_by_gid[g.gid].pop(0),
                                     pages, shared, stream))
                        placed = True
                if not placed and shared:
                    g.allocator.free(shared)
            if not placed:               # every pool exhausted: wait
                self.n_admit_deferred += 1
                self.queue.push_front(req)
                break
        if not wave:
            return
        if self.tracker is not None:
            # each request must land in the group whose allocator its pages
            # came from — restrict the master's choice to that group's slots
            choices = ({req.rid: g.slot_ids for req, g, *_ in wave}
                       if len(self.groups) > 1 else None)
            assign = self.tracker.place_batch([w[0] for w in wave], all_free,
                                              slot_choices=choices)
        else:
            assign = {w[0].rid: w[2] for w in wave}
        for req, _, _, pages, shared, stream in wave:
            if self.paged:
                self._start_prefill(req, assign[req.rid], pages, shared,
                                    stream)
            else:
                self._insert(req, assign[req.rid])

    # -- deadlines (DESIGN.md §14) ---------------------------------------------
    def _deadline_drop_queued(self, req: Request) -> bool:
        """Deadline screen for a POPPED queue entry, moments before pages
        are charged for it: a request whose total deadline passed while it
        waited expires; a FRESH request (no retained first token — a
        resume's TTFT is already history) whose TTFT deadline passed is
        shed.  Returns True when the request was dropped."""
        if not self.enforce_deadlines:
            return False
        now = self.clock()
        waited = now - req.arrival_s
        if (req.total_deadline_s is not None
                and waited > req.total_deadline_s):
            self._terminate(req, "expired",
                            detail="total deadline passed in queue")
            return True
        if (req.ttft_deadline_s is not None
                and req.rid not in self._suspended
                and waited > req.ttft_deadline_s):
            self._terminate(req, "shed_deadline",
                            detail="TTFT deadline passed in queue")
            return True
        return False

    def _deadline_class(self, st: SlotState, now: float) -> int:
        """Victim-priority class of a RUNNING slot: 0 — hopeless (its total
        deadline cannot be met even undisturbed, at the current step EWMA),
        1 — no deadline declared, 2 — on track.  Victim selection takes
        hopeless requests first and on-track ones last: evicting work that
        will count to admit work that won't is the inversion deadline-aware
        preemption exists to prevent."""
        req = st.request
        # getattr: victim-policy tests fake requests with bare objects
        deadline = getattr(req, "total_deadline_s", None)
        if not self.enforce_deadlines or req is None or deadline is None:
            return 1
        eta = now + max(st.budget, 0) * self._ewma_step_s
        return 0 if eta > req.arrival_s + deadline else 2

    def _hopeless(self, req: Request) -> bool:
        """Can this QUEUED request no longer meet its total deadline even
        if admitted immediately and never disturbed (EWMA estimate)?"""
        if not self.enforce_deadlines or req.total_deadline_s is None:
            return False
        done = (len(self._suspended[req.rid].tokens)
                if req.rid in self._suspended else 0)
        if self.paged:
            n_chunks = -(-max(len(req.tokens) + max(done - 1, 0), 1)
                         // self.engine.chunk_len)
        else:
            n_chunks = 1
        eta = (self.clock()
               + (n_chunks + req.max_new - done) * self._ewma_step_s)
        return eta > req.arrival_s + req.total_deadline_s

    # -- reserve-on-demand: preemption -----------------------------------------
    def _floor_ok(self, st: SlotState) -> bool:
        """Resume-progress floor: a resumed request is not a preemption
        victim again until it has generated ``resume_floor`` NEW tokens."""
        return (st.resume_base == 0
                or len(st.tokens) - st.resume_base >= self.resume_floor)

    def _choose_victim(self, g: DeviceGroup, *, shortfall: int = 1,
                       spare_on_track: bool = False) -> SlotState | None:
        """Pick the lowest-priority running slot of GROUP ``g`` to preempt,
        or None — a victim's pages only help an allocation from the same
        group's pool.

        Candidates are live decoding slots (mid-prefill slots hold work
        nothing has been sampled from yet).  Deadline class ranks first —
        hopeless requests (total deadline unmeetable) are preempted before
        deadline-free ones, and on-track ones last (``spare_on_track``
        excludes them outright: set when the beneficiary itself cannot meet
        its deadline).  Within a class, policy ``fewest``: fewest generated
        tokens — the cheapest recompute — with LIFO (latest admitted) as
        the tiebreak; ``lifo``: latest admitted outright.
        Guards: the victim's pages must actually cover ``shortfall`` (the
        pages still missing after the free pool — preempting someone and
        STILL failing the allocation is pure thrash), and the victim must
        pass the resume-progress floor.  When no slot is eligible, the
        caller that cannot proceed without a page self-preempts
        (``_ensure_decode_pages``) — the one case that overrides the
        floor, since the alternative is a write into an unowned page."""
        now = self.clock()
        cands = [s for s in (self.slots[i] for i in g.slot_ids)
                 if s.request is not None and not s.prefilling
                 and not s.finished and self._floor_ok(s)
                 and self._n_exclusive(s) >= shortfall]
        if spare_on_track:
            cands = [s for s in cands if self._deadline_class(s, now) < 2]
        if not cands:
            return None
        if self.preempt_policy == "lifo":
            return min(cands, key=lambda s: (self._deadline_class(s, now),
                                             -s.admit_seq))
        return min(cands, key=lambda s: (self._deadline_class(s, now),
                                         len(s.tokens), -s.admit_seq))

    def _n_exclusive(self, st: SlotState) -> int:
        """Pages preempting this slot would actually return to the free
        list: only its EXCLUSIVELY held ones.  Freeing a shared page merely
        drops one reference — the prefix cache (or another slot) still
        holds it — so counting raw ``page_ids`` would overstate a victim's
        yield and re-introduce the preempt-and-still-fail thrash the
        shortfall guard exists to prevent."""
        alloc = self._slot_group[st.slot].allocator
        return sum(1 for p in st.page_ids if alloc.writable(p))

    def _suspend(self, st: SlotState) -> None:
        """Record the slot's generated tokens as the resume state of its
        request (preemption, or worker failure under demand mode) — and,
        with a tracker, in its durable store."""
        prev = self._suspended.get(st.request.rid)
        sus = _Suspended(
            tokens=list(st.tokens), token_s=list(st.token_s),
            n_preempts=(prev.n_preempts + 1 if prev else 1))
        self._suspended[st.request.rid] = sus
        if self.tracker is not None:
            self.tracker.persist_suspended(st.request.rid, sus.tokens,
                                           sus.token_s, sus.n_preempts)

    def _clear_slot(self, st: SlotState) -> None:
        """Reset a slot's host-side bookkeeping to free (pages must already
        be released)."""
        st.request, st.finished = None, False
        st.tokens, st.token_s, st.pending_chunks = [], [], []
        st.resume, st.resume_base, st.prefill_tokens = None, 0, None

    def _preempt(self, st: SlotState) -> None:
        """Reclaim the slot's pages: retain the generated tokens host-side,
        free the pages (the slot parks on the trash page) and put the
        request back at the queue FRONT so it resumes — by chunked
        re-prefill — as soon as pages free up."""
        req = st.request
        self._suspend(st)
        self.n_preempted += 1
        if self.tracker is not None:
            self.tracker.preempt(req)
        self._release_slot(st)
        self._clear_slot(st)
        self.queue.push_front(req)

    def _evict_request(self, st: SlotState, *,
                       count_restart: bool = False) -> int | None:
        """Fault-path eviction — the shared tail of ``fail_slot``, a step
        watchdog trip and group failover.  The slot's device state is
        gone/untrusted; its request goes back through recovery: under
        reserve-on-demand a decoding slot's generated tokens suspend
        (recompute-on-resume keeps TTFT and tokens), a slot evicted
        mid-resume puts its retained record back, anything else re-queues
        from scratch — at the queue front.  ``count_restart`` charges the
        per-request restart budget: a request evicted more than
        ``max_restarts`` times ends ``failed`` instead of re-queued (a
        poison request cannot cycle through fault recovery forever).
        Returns the rid, or None for a free slot."""
        req = st.request
        if req is None:
            return None
        if self.demand and st.tokens and not st.prefilling \
                and not st.finished:
            self._suspend(st)
        elif self.demand and st.resume is not None:
            # evicted mid-resume-prefill: the retained tokens are still the
            # suspended record — put it back for the next resume attempt
            self._suspended[req.rid] = st.resume
            if self.tracker is not None:
                self.tracker.persist_suspended(
                    req.rid, st.resume.tokens, st.resume.token_s,
                    st.resume.n_preempts)
        self._release_slot(st)
        self._clear_slot(st)
        if count_restart and self.max_restarts is not None:
            self._restarts[req.rid] = self._restarts.get(req.rid, 0) + 1
            if self._restarts[req.rid] > self.max_restarts:
                self._terminate(req, "failed",
                                detail=f"restart budget "
                                       f"{self.max_restarts} exhausted")
                return req.rid
        self.queue.push_front(req)
        return req.rid

    def _ensure_decode_pages(self, live: list[SlotState]) -> list[SlotState]:
        """Reserve-on-demand: before the decode step, make sure every live
        slot owns the page its next KV write lands in (write index =
        ``pos - 1``), appending from the pool at page boundaries.  On
        exhaustion the victim policy picks who loses their pages; the
        appending slot is an ordinary candidate when eligible, and the
        forced fallback — floor notwithstanding — when no slot is (it
        cannot decode without the page).  Returns the slots that still
        hold a live request."""
        ps = self.engine.page_size
        # most-progressed slots claim free pages first: if the pool is
        # short, the policy wants the LEAST progressed slot to lose — this
        # order avoids append-then-get-preempted churn within one step
        order = sorted(live, key=lambda s: (-len(s.tokens), s.admit_seq))
        for st in order:
            g = self._slot_group[st.slot]
            while st.request is not None:
                widx = st.pos - 1        # next KV write position
                if widx >= len(st.page_ids) * ps:
                    pg = self._alloc_pages(g, 1)
                    if pg is not None:
                        st.page_ids.append(pg[0])
                        self.engine.append_page(st.slot, pg[0])
                        continue
                elif g.allocator.writable(st.page_ids[widx // ps]):
                    break
                elif self._cow_page(st, widx // ps):
                    # decode write would land in a SHARED page: copied and
                    # remapped, the slot now writes its private page
                    break
                victim = self._choose_victim(g)
                if victim is None:
                    victim = st          # floor protects only from OTHERS
                self._preempt(victim)
        return [s for s in live if s.request is not None]

    def _cow_page(self, st: SlotState, pidx: int) -> bool:
        """Copy-on-write: give the slot a private copy of its shared page
        ``pidx`` — allocate a fresh page, copy the pool block, swap the
        slot's mapping (``page_ids`` and, for a committed slot, the live
        table row) and release the slot's reference on the original (the
        other holders keep reading it untouched).  Returns False when the
        pool cannot supply the copy target — the caller preempts and
        retries."""
        g = self._slot_group[st.slot]
        pg = self._alloc_pages(g, 1)
        if pg is None:
            return False
        src, dst = st.page_ids[pidx], pg[0]
        self.engine.copy_page(src, dst)
        st.page_ids[pidx] = dst
        if not st.prefilling:
            # mid-prefill slots' live rows park on the trash page; their
            # real row is installed wholesale by commit_slot
            self.engine.remap_slot_page(st.slot, pidx, dst)
        g.allocator.free([src])
        self.n_cow_copies += 1
        return True

    def _release_slot(self, st: SlotState) -> None:
        """Hand the slot's pages back to its group's pool and point its
        page-table row at the trash page (paged engines only)."""
        if self.paged and st.page_ids:
            self._slot_group[st.slot].allocator.free(st.page_ids)
            self.engine.free_slot(st.slot)
            st.page_ids = []

    def _deadlines_met(self, req: Request, res: RequestResult) -> bool:
        """Did the request meet every deadline it declared — the goodput
        criterion (no deadline declared counts as met)."""
        if (req.ttft_deadline_s is not None
                and res.ttft_s > req.ttft_deadline_s):
            return False
        return (req.total_deadline_s is None
                or res.finish_s - req.arrival_s <= req.total_deadline_s)

    def _retire_finished(self) -> None:
        now = self.clock()
        for st in self.slots:
            if st.request is None or not st.finished:
                continue
            req = st.request
            res = RequestResult(rid=req.rid, prompt_len=len(req.tokens),
                                tokens=list(st.tokens),
                                arrival_s=req.arrival_s,
                                token_s=list(st.token_s), finish_s=now)
            self.results.append(res)
            self._record_outcome(req.rid, "completed")
            if self._deadlines_met(req, res):
                self.goodput_tokens += res.n_generated
            if self._last_retire_s is not None:
                dt = now - self._last_retire_s
                self._ewma_retire_s = (
                    dt if self._ewma_retire_s == 0.0
                    else 0.7 * self._ewma_retire_s + 0.3 * dt)
            self._last_retire_s = now
            if self.tracker is not None:
                self.tracker.finish(req, st.slot, np.asarray(st.tokens))
                self.tracker.retire(req)
            self._release_slot(st)
            self._clear_slot(st)

    def _expire_running(self) -> None:
        """Retire in-flight requests whose TOTAL deadline has passed: the
        slot frees immediately (its remaining decode steps would be pure
        waste — the client stopped listening), partial work is discarded
        and the ``expired`` outcome recorded."""
        now = self.clock()
        for st in self.slots:
            req = st.request
            if (req is None or req.total_deadline_s is None
                    or now - req.arrival_s <= req.total_deadline_s):
                continue
            self._release_slot(st)
            self._clear_slot(st)
            self._terminate(req, "expired",
                            detail="total deadline passed mid-flight")

    def fail_slot(self, slot: int) -> int | None:
        """Simulate losing a slot's device-local KV (worker failure).  Under
        full-lifetime reservation the in-flight request restarts from its
        prompt; under reserve-on-demand the generated tokens live host-side
        anyway (the preemption path retains them), so recovery reuses the
        resume machinery — the request recomputes prompt + retained tokens
        instead of regenerating from scratch.  Returns the rid (None for a
        free slot)."""
        return self._fault_evict(self.slots[slot])

    def _fault_evict(self, st: SlotState) -> int | None:
        """A fault made the slot's device state untrusted (``fail_slot``,
        group failover, a watchdog trip): with a tracker the slot's worker
        fails first — its retained results are invalidated, the request's
        job leaves the graph and a replacement worker takes the slot —
        then the request goes back through recovery, charged to its
        restart budget.  (The JAX package's watchdog evicts without
        telling the tracker, so under HyPar placement the request's job
        stays in the graph and its re-admission adds a second job of the
        same name, which the graph refuses.)"""
        if self.tracker is not None:
            self.tracker.fail(st.slot, rid=st.request.rid if st.request
                              else None)
        return self._evict_request(st, count_restart=True)

    # -- group failover (DESIGN.md §14) ----------------------------------------
    def fail_group(self, gid: int, *, reason: str = "injected") -> int:
        """Mark device group ``gid`` unhealthy and quarantine it: every
        in-flight request on its slots is evicted back through the recovery
        path (the next admission wave re-routes them to healthy groups —
        page ownership still never crosses a group boundary, the request
        simply re-prefills from the new group's pool), its prefix cache is
        flushed (KV resident on a failed device is untrusted), any
        chaos-held pages are released, and the allocator is leak-checked:
        a quarantined group must own ZERO outstanding pages.  Returns the
        number of evicted requests.  The group rejoins via
        :meth:`probe_group`, attempted automatically every
        ``probe_interval_steps * probe_backoff`` scheduler calls."""
        g = self.groups[gid]
        if not g.healthy:
            return 0
        g.healthy = False
        g.down_step = self.step_calls
        # failing again shortly after a rejoin doubles the probe interval
        # (capped) instead of flapping at constant cadence; a long stable
        # stretch forgives the history and a fresh incident starts back at
        # the base cadence
        stable_steps = self.probe_interval_steps * self.rejoin_backoff_cap
        if g.up_step and self.step_calls - g.up_step < stable_steps:
            g.probe_backoff = min(g.probe_backoff * 2,
                                  self.rejoin_backoff_cap)
        else:
            g.probe_backoff = 1
        g.backoff_wall = self.clock()
        n = 0
        for slot in g.slot_ids:
            st = self.slots[slot]
            if st.request is None:
                continue
            self._fault_evict(st)
            n += 1
        if g.prefix is not None:
            g.prefix.flush(g.allocator)
        if self.chaos is not None:
            self.chaos.release_pages(self, gid=gid)
        if g.allocator is not None and g.allocator.n_outstanding:
            raise RuntimeError(
                f"group {gid} failed ({reason}) with "
                f"{g.allocator.n_outstanding} pages still outstanding — "
                f"quarantine leak")
        self.n_group_failovers += 1
        return n

    def probe_group(self, gid: int) -> bool:
        """Health probe for an unhealthy group: the chaos gate (is the
        injected fault still active?), a real device round-trip through the
        engine (:meth:`PagedEngine.probe_device`: the group's own devices
        under a mesh, else the engine's one device), and the quarantine
        invariant (allocator fully drained).  On success the group rejoins
        admission with its trip counter cleared; on failure the probe
        interval re-arms and the backoff multiplier doubles (capped at
        ``rejoin_backoff_cap``), so a dead group is probed exponentially
        less often instead of at constant cadence."""
        g = self.groups[gid]
        if g.healthy:
            return True
        if g.backoff_wall is not None:
            # close the waiting window opened at the last re-arm
            self.rejoin_backoff_s += self.clock() - g.backoff_wall
            g.backoff_wall = None
        if ((self.chaos is not None
             and not self.chaos.group_healthy(self, gid))
                or not (self.engine.probe_device(group=gid) if self.paged
                        else self.engine.probe_device())):
            g.down_step = self.step_calls
            g.probe_backoff = min(g.probe_backoff * 2,
                                  self.rejoin_backoff_cap)
            g.backoff_wall = self.clock()
            return False
        if g.allocator is not None and g.allocator.n_outstanding:
            raise RuntimeError(
                f"group {gid} cannot rejoin: {g.allocator.n_outstanding} "
                f"pages leaked while quarantined")
        g.healthy = True
        g.watchdog_trips = 0
        g.up_step = self.step_calls
        self.n_group_rejoins += 1
        return True

    def _probe_groups(self) -> None:
        for g in self.groups:
            if (not g.healthy and self.step_calls - g.down_step
                    >= self.probe_interval_steps * g.probe_backoff):
                self.probe_group(g.gid)

    # -- step watchdog (DESIGN.md §14) -----------------------------------------
    def _chaos_extra_s(self, gid: int) -> float:
        """Injected slow-step seconds for this group — added to the
        MEASURED step duration, not slept, so chaos runs stay fast and the
        watchdog sees exactly what a wedged device would show it."""
        return (self.chaos.step_extra_s(self, gid)
                if self.chaos is not None else 0.0)

    def _watch_prefill(self, st: SlotState, dt: float) -> None:
        """Wall-clock budget around one prefill chunk: an over-budget slot
        is evicted back through the recovery path (the chunk may be wedged
        — its work is recomputed elsewhere) and its group moves toward
        unhealthy."""
        if self.watchdog_budget_s is None or st.request is None:
            return
        g = self._slot_group[st.slot]
        if dt + self._chaos_extra_s(g.gid) <= self.watchdog_budget_s:
            return
        self.watchdog_trips += 1
        g.watchdog_trips += 1
        self._fault_evict(st)
        if g.healthy and g.watchdog_trips >= self.unhealthy_after:
            self.fail_group(g.gid, reason="watchdog")

    def _watch_decode(self, live: list[SlotState], dt: float) -> None:
        """Wall-clock budget around the decode wave.  One decode call spans
        the whole batch, so finer attribution than per-group is impossible:
        every group with live slots in an over-budget wave takes a trip and
        evicts its least-progressed live slot (the cheapest recompute —
        possibly the wedged one; repeat offenders drive the group to
        unhealthy either way)."""
        if self.watchdog_budget_s is None:
            return
        for g in self.groups:
            mine = [s for s in live if s.slot in g.slot_ids]
            if not mine:
                continue
            if dt + self._chaos_extra_s(g.gid) <= self.watchdog_budget_s:
                continue
            self.watchdog_trips += 1
            g.watchdog_trips += 1
            victim = min((s for s in mine if s.request is not None
                          and not s.finished),
                         key=lambda s: (len(s.tokens), -s.admit_seq),
                         default=None)
            if victim is not None:
                self._fault_evict(victim)
            if g.healthy and g.watchdog_trips >= self.unhealthy_after:
                self.fail_group(g.gid, reason="watchdog")

    # -- the loop --------------------------------------------------------------
    def step(self) -> bool:
        """Fill free slots, advance one prefill chunk per mid-prefill slot,
        run one decode step over the live batch, retire finished requests.
        Returns False when nothing is in flight.

        Chunk interleaving policy: one chunk per prefilling slot per step,
        decode in between — a long prompt costs its chunk count in steps,
        but the live batch keeps emitting tokens throughout instead of
        stalling for the whole prompt (the utilisation loss the paper's
        overlapping-segments design warns about)."""
        self.step_calls += 1
        if self.chaos is not None:
            self.chaos.on_step(self)
        self._probe_groups()
        self._fill_free_slots()
        for st in self.slots:
            if st.prefilling:
                t0 = self.clock()
                self._advance_prefill(st)
                self._watch_prefill(st, self.clock() - t0)
        self._retire_finished()          # budget-1 requests end at prefill
        if self.enforce_deadlines:
            self._expire_running()
        live = [s for s in self.slots
                if s.request is not None and not s.prefilling]
        if self.demand and live:
            # reserve-on-demand: appends (or preemptions) BEFORE the decode
            # write that would cross into an unowned page
            live = self._ensure_decode_pages(live)
        prefilling = [s for s in self.slots if s.prefilling]
        if not live:
            return bool(prefilling) or len(self.queue) > 0
        t0 = self.clock()
        tokens = np.zeros((self.engine.batch, 1), np.int32)
        for st in live:
            tokens[st.slot, 0] = st.next_token
        if self.paged:
            # freeze mid-prefill (and free) slots' SSM state: only slots
            # decoding a real token may advance their per-slot buffers
            mask = np.zeros((self.engine.batch,), bool)
            for st in live:
                mask[st.slot] = True
            ids = self._sample(self.engine.decode(tokens, live_mask=mask))
        else:
            ids = self._sample(self.engine.decode(tokens))
        now = self.clock()
        self.n_steps += 1
        self.occupied_slot_steps += len(live) + len(prefilling)
        self._ewma_step_s = (now - t0 if self._ewma_step_s == 0.0
                             else 0.7 * self._ewma_step_s
                             + 0.3 * (now - t0))
        if self.tracker is not None:
            self.tracker.observe(now - t0, len(live))
        busy = {s.slot for s in live} | {s.slot for s in prefilling}
        for g in self.groups:
            g.occupied_slot_steps += sum(1 for s in g.slot_ids if s in busy)
            g_live = sum(1 for s in live if s.slot in g.slot_ids)
            if g_live:
                g.observe((now - t0) / g_live)
        for st in live:
            tok = int(ids[st.slot])
            st.tokens.append(tok)
            st.token_s.append(now)
            st.next_token = tok
            st.pos += 1
            st.budget -= 1
            if st.budget <= 0 or (self.sp.stop_token >= 0
                                  and tok == self.sp.stop_token):
                st.finished = True
        # watchdog AFTER token bookkeeping: an evicted slot's suspended
        # record then includes this wave's token, so resume recomputes the
        # exact state and the output still bit-matches
        self._watch_decode(live, now - t0)
        self._retire_finished()
        return True

    def run(self, requests: Iterable[Request] | None = None,
            ) -> list[RequestResult]:
        """Drive to completion.  Without ``requests``, drains whatever is in
        the queue.  With ``requests`` (relative ``arrival_s`` stamps), does a
        timed open-loop replay: each request is submitted once the wall
        clock passes its arrival offset — the Poisson-trace mode of
        ``launch/serve.py``."""
        pending: deque[Request] = deque()
        if requests is not None:
            pending.extend(sorted(requests, key=lambda r: r.arrival_s))
        t0 = self.clock()
        while True:
            now = self.clock() - t0
            while pending and pending[0].arrival_s <= now:
                req = pending.popleft()
                req.arrival_s += t0      # rebase onto the scheduler clock
                self._admit(req)         # same admission as submit()
            if not self.step():
                if pending:
                    time.sleep(min(max(pending[0].arrival_s - now, 0.0),
                                   0.005))
                    continue
                if len(self.queue) == 0:
                    break
        return self.results

    def reset_metrics(self) -> None:
        """Clear results and counters after a warmup pass so a measured run
        on the SAME scheduler (and the same engine) starts from clean
        figures.  Slots must be drained first."""
        if any(not s.free for s in self.slots) or len(self.queue):
            raise RuntimeError("reset_metrics() with requests still in "
                               "flight")
        if self._suspended:
            raise RuntimeError(f"reset_metrics() with suspended requests "
                               f"{sorted(self._suspended)} — preempted "
                               f"requests must resume before the drain")
        self.results = []
        self.n_steps = 0
        self.occupied_slot_steps = 0
        self.queue.n_submitted = 0
        self.queue.reset_shed()
        self.n_preempted = 0
        self.n_admit_deferred = 0
        self.resume_tokens_recomputed = 0
        self.n_prefix_lookups = 0
        self.n_prefix_hits = 0
        self.pages_shared = 0
        self.n_cow_copies = 0
        self.n_cache_insert_deferred = 0
        self.outcomes = {}
        self._restarts = {}
        self.watchdog_trips = 0
        self.n_expired = 0
        self.n_failed = 0
        self.n_group_failovers = 0
        self.n_group_rejoins = 0
        self.rejoin_backoff_s = 0.0
        self.goodput_tokens = 0
        self._last_retire_s = None
        # _ewma_step_s / _ewma_retire_s and the groups' step EWMAs survive
        # — they are calibration, not run metrics
        for g in self.groups:
            g.occupied_slot_steps = 0
            g.watchdog_trips = 0

    def flush_prefix_cache(self) -> int:
        """Drop every prefix-cache entry in every group, releasing the
        caches' page references (pages shared with live slots stay
        outstanding under the slots' refs).  Returns the number of entries
        dropped — used after warmup so a measured run starts from a cold
        cache, and at drain checks to prove zero leaked references."""
        return sum(g.prefix.flush(g.allocator) for g in self.groups
                   if g.prefix is not None)

    # -- metrics ---------------------------------------------------------------
    @property
    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per decode step."""
        if self.n_steps == 0:
            return 0.0
        return self.occupied_slot_steps / (self.n_steps * self.engine.batch)

    @property
    def group_occupancy(self) -> list[float]:
        """Per-device-group mean busy-slot fraction — the cost-model
        router's balance evidence (both groups nonzero under load)."""
        if self.n_steps == 0:
            return [0.0 for _ in self.groups]
        return [g.occupied_slot_steps / (self.n_steps * len(g.slot_ids))
                for g in self.groups]
