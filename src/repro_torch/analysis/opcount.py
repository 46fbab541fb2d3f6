"""Operation counter: the port's counterpart of the JAX package's HLO-text
analyser (``analysis/hlo.py``).

The reference compiles a step with XLA and reads the partitioned HLO text.
The port runs eagerly, so it counts what the step dispatches instead:
:class:`OpCounter` is a ``TorchDispatchMode`` that sees every aten op the
step runs, on ``meta`` tensors (the dry-run: no memory, no kernel) or on
the card (the same step, live).  It records, for each position of the
traced grid row:

* **flops** of the matmul-class ops, from the formulas
  ``torch.utils.flop_counter`` registers (mm, addmm, bmm, baddbmm,
  convolution and their backward), the reference's dot/convolution
  accounting (``hlo.py:196-270``); a hand-written kernel adds its own
  ``cost()`` through :func:`kernel` instead, since its work is no aten op;
* **traffic bytes**: each materialising op reads its operands and writes
  its output, hlo.py's upper-bound model.  View ops are free, as bitcasts
  are; allocations (``empty``) write nothing; gathers and scatters move
  twice their smaller side, as hlo.py's ``gather``/``dynamic-slice`` do;
* **collectives** by kind and bytes (:class:`CollectiveStats`, hlo.py's
  ``all-reduce`` counted as twice its operand, ``all-gather`` as its
  output, the others as their operand), recorded by the mesh code at each
  cross-position hand-off through :func:`collective`, and in the backward
  pass through :func:`shard_input`: the gradient of an input that every
  shard reads is the shards' sum, the all-reduce that pairs with the
  forward's;
* **the peak of live bytes**: every storage an op creates is counted
  live until a weakref finalizer sees it freed (the tensors autograd
  saves included), and the peak of the running sum is kept.  It replaces
  ``memory_analysis()``'s temporaries; the caller adds the position's
  parameter, optimizer and cache bytes, which exist before the trace;
* **a per-op table** (calls, flops, traffic by op name) for
  ``launch/diagnose.py``;
* **the gathered high-water mark** of each grid position
  (:class:`GatherMarks`): the bytes of the parameter regions a training
  mesh gathers (``parallel.partition.take_regions``) that are still alive,
  freed through weakref finalizers as the peak of live bytes is, and the
  most bytes one gather scope (a block, the embedding, the logits:
  :func:`gather_scope`) gathers a position.  The marks also run without
  a counter (:func:`gather_marks`), on the card.

A trace of one data row that stands for a whole production grid (the
dry-run's) is told so by :func:`production`: a Placed leaf's ``share`` is
the fraction of its row block that a production position holds (the
data axes the row does not have).  The gradient sums a row keeps at its
blocks are then counted live at that share (:func:`scaled_live`), as the
reference's reduce-scatter over ``data`` leaves them, and so are the
optimizer's temporaries of each block it updates, and each gather
records as an all-gather also the part of its region that a production
position would fetch from the other data rows.

Nothing of hlo.py's trip-count correction is ported, and neither is
``xla_cost_analysis``: the eager trace runs every layer, so its counts
need no loop correction.  One loop may be sampled: a training step's
micro-batches are alike, so a counter made with ``sample_micro=k`` runs
only the first k of them (:func:`micro_batches`) and counts the k-th once
for each one left out.  The peak of live bytes is the k-th's, which
already finds the previous micro-batches' gradients held.

**Positions.**  One process drives every position of a grid row, so the
counter needs to be told whose work an op is.  The mesh code walks a
row's tensor-parallel shards through :func:`each_position`, which sets
the current position while a shard's body runs; ops outside it are the
row lead's (position 0).  A ``TorchFunctionMode`` tags the autograd node
each op creates with the position it ran at, so the backward pass, which
runs those nodes later, counts each gradient op where its forward ran
(``torch._C._current_autograd_node``).

Outside a counter every hook here is a no-op: :func:`each_position` only
enumerates, :func:`collective` and :func:`kernel` return at once.  One
counter is active at a time in a process (the backward of a CUDA tensor
runs on an autograd worker thread, which must see it too).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Callable, Iterable, Iterator

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["COLLECTIVES", "CollectiveStats", "GatherMarks", "OpAnalysis",
           "OpCounter", "PositionCounts", "active", "at_position",
           "collective", "current_position", "each_position",
           "gather_marks", "gather_scope", "gathered", "kernel",
           "micro_batches", "production", "scaled_live", "shard_input",
           "share", "tensor_bytes", "tracking"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
#: ops that allocate without writing: no traffic (a later op writes them)
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten.detach.default,
               _aten.lift_fresh.default}
#: gathers move what they select: twice the smaller of operands and output
_GATHERS = {"index", "index_select", "gather", "embedding", "take",
            "take_along_dim"}
#: scatters touch what they update: twice the update operand
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "index_add",
             "index_add_", "scatter", "scatter_", "scatter_add",
             "scatter_add_", "scatter_reduce", "scatter_reduce_",
             "index_copy", "index_copy_", "embedding_dense_backward"}

_ACTIVE: "OpCounter | None" = None
_POSITION: int | None = None
_MARKS: "GatherMarks | None" = None


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s elements (a view counts its own, not its
    storage's)."""
    return t.numel() * t.element_size()


def active() -> "OpCounter | None":
    """The counter that is tracing, or None."""
    return _ACTIVE


def tracking() -> bool:
    """Whether a counter or gathered marks (:func:`gather_marks`) are
    recording: the mesh code skips its records' arithmetic otherwise."""
    return _ACTIVE is not None or _MARKS is not None


def current_position() -> int:
    """The grid position whose work runs now: the shard that
    :func:`each_position` is walking, else, in a backward pass, the
    position the current autograd node's forward ran at, else the lead
    (0)."""
    if _POSITION is not None:
        return _POSITION
    node = torch._C._current_autograd_node()
    if node is not None:
        return node.metadata.get("position", 0)
    return 0


def each_position(items: Iterable) -> Iterator:
    """Yield ``items`` in order, the i-th while position i is current: a
    loop over a row's shards (lead first) written ``for shard in
    each_position(shards)`` counts each shard's body at its position.
    Outside a counter it yields the items and sets nothing."""
    global _POSITION
    if _ACTIVE is None:
        yield from items
        return
    before = _POSITION
    try:
        for i, item in enumerate(items):
            _POSITION = i
            yield item
    finally:
        _POSITION = before


@contextlib.contextmanager
def at_position(pos: int):
    """Count what runs inside at position ``pos`` (a position of the
    traced row) whatever walk is current; nothing outside a counter."""
    global _POSITION
    if _ACTIVE is None:
        yield
        return
    before = _POSITION
    _POSITION = pos
    try:
        yield
    finally:
        _POSITION = before


@contextlib.contextmanager
def production(share_fn: Callable):
    """Inside, the traced row stands for a production grid: ``share_fn(
    leaf)`` is the fraction of a Placed leaf's row block that a production
    position holds (:func:`share`).  A no-op outside a counter."""
    counter = _ACTIVE
    if counter is None:
        yield
        return
    before = counter.share_fn
    counter.share_fn = share_fn
    try:
        yield
    finally:
        counter.share_fn = before


def share(leaf) -> float:
    """The fraction of ``leaf``'s row block a production position holds:
    1 outside :func:`production`."""
    counter = _ACTIVE
    if counter is None or counter.share_fn is None:
        return 1.0
    return float(counter.share_fn(leaf))


@contextlib.contextmanager
def scaled_live(factor: float):
    """Count the storages made inside live at ``factor`` of their bytes
    (a gradient sum at its production share); a no-op outside a
    counter."""
    counter = _ACTIVE
    if counter is None or factor == 1.0:
        yield
        return
    before = counter.live_scale
    counter.live_scale = factor
    try:
        yield
    finally:
        counter.live_scale = before


class GatherMarks:
    """The gathered high-water mark of each grid position (keys are the
    mesh's flat positions): ``live`` the bytes gathered and still alive,
    ``peak`` their most, ``scope`` the most one :func:`gather_scope`
    gathered there."""

    def __init__(self):
        self.live: dict[int, int] = defaultdict(int)
        self.peak: dict[int, int] = defaultdict(int)
        self.scope: dict[int, int] = defaultdict(int)
        self._open: list[dict[int, int]] = []

    def _freed(self, pos: int, nbytes: int) -> None:
        self.live[pos] -= nbytes

    def add(self, t: torch.Tensor, pos: int) -> None:
        nbytes = tensor_bytes(t)
        self.live[pos] += nbytes
        self.peak[pos] = max(self.peak[pos], self.live[pos])
        weakref.finalize(t.untyped_storage(), self._freed, pos, nbytes)
        for sc in self._open:
            sc[pos] = sc.get(pos, 0) + nbytes

    def as_lists(self, n: int) -> tuple[list[int], list[int]]:
        """``(peak, scope)`` of positions 0 .. n-1."""
        return ([self.peak.get(k, 0) for k in range(n)],
                [self.scope.get(k, 0) for k in range(n)])


@contextlib.contextmanager
def gather_marks():
    """Track the gathered high-water marks of what runs inside (yields
    the :class:`GatherMarks`), with or without a counter."""
    global _MARKS
    before, _MARKS = _MARKS, GatherMarks()
    try:
        yield _MARKS
    finally:
        _MARKS = before


def gathered(t: torch.Tensor, pos: int) -> None:
    """Record ``t``, a region a position gathered, alive at mesh position
    ``pos`` until its storage is freed.  A no-op unless marks are
    tracked."""
    if _MARKS is not None:
        _MARKS.add(t, pos)


@contextlib.contextmanager
def gather_scope():
    """One gather scope (a block, the embedding, the logits): what each
    position gathers inside is added up, and the most is kept
    (``GatherMarks.scope``)."""
    marks = _MARKS
    if marks is None:
        yield
        return
    sc: dict[int, int] = {}
    marks._open.append(sc)
    try:
        yield
    finally:
        marks._open.remove(sc)
        for pos, nbytes in sc.items():
            marks.scope[pos] = max(marks.scope[pos], nbytes)


def micro_batches(items: Iterable) -> Iterator:
    """Yield a step's micro-batches.  Under a counter that samples them
    (``OpCounter(sample_micro=k)``), yield only the first k and count the
    last of those once for itself and once for each one left out; else
    yield them all."""
    counter = _ACTIVE
    if counter is None or not counter.sample_micro:
        yield from items
        return
    items = list(items)
    k = min(counter.sample_micro, len(items))
    for i, item in enumerate(items[:k]):
        counter.weight = len(items) - k + 1 if i == k - 1 else 1
        try:
            yield item
        finally:
            counter.weight = 1


def collective(kind: str, *tensors: torch.Tensor, nbytes: int | None = None,
               site: str = "", position: int | None = None) -> None:
    """Record one cross-position hand-off at ``position`` (default the
    current one): ``kind`` in :data:`COLLECTIVES`, its operand ``tensors``
    (or ``nbytes``; for an all-gather, the gathered output's bytes),
    counted as hlo.py counts the collective.  A no-op outside a
    counter."""
    if _ACTIVE is None:
        return
    if nbytes is None:
        nbytes = sum(tensor_bytes(t) for t in tensors)
    _ACTIVE.add_collective(kind, nbytes, site=site, position=position)


class _SumOverShards(torch.autograd.Function):
    """The identity; its backward records the all-reduce of the gradient
    at the position its forward ran at."""

    @staticmethod
    def forward(ctx, x, site):
        ctx.site = site
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        collective("all-reduce", grad, site=ctx.site)
        return grad, None


def shard_input(x: torch.Tensor, site: str) -> torch.Tensor:
    """``x`` as one tensor-parallel shard reads it.  Under a counter, where
    ``x`` takes a gradient, that gradient's sum over the shards is recorded
    as an all-reduce at ``site`` when the backward reaches it; else ``x``
    itself."""
    if _ACTIVE is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _SumOverShards.apply(x, site)


def kernel(name: str, cost: dict) -> None:
    """Record one hand-written kernel's work (its ``cost()``: ``flops``
    and ``bytes``) at the current position.  A no-op outside a counter."""
    if _ACTIVE is not None:
        _ACTIVE.add_kernel(name, cost)


@dataclasses.dataclass
class CollectiveStats:
    counts: dict[str, int]
    bytes_by_kind: dict[str, float]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass
class PositionCounts:
    """What one grid position did in a trace."""

    flops: float = 0.0
    matmul_flops: float = 0.0
    traffic_bytes: float = 0.0
    collectives: CollectiveStats = dataclasses.field(
        default_factory=lambda: CollectiveStats(
            {k: 0 for k in COLLECTIVES}, {k: 0.0 for k in COLLECTIVES}))
    live_bytes: int = 0
    peak_bytes: int = 0


@dataclasses.dataclass
class OpAnalysis:
    """A trace's counts: every position's, and the per-device figures the
    roofline reads, each the maximum over the positions."""

    positions: list[PositionCounts]
    by_op: dict[str, dict]
    by_site: dict[tuple, dict]
    #: each mesh position's gathered high-water mark and largest scope
    gathered: list[int] = dataclasses.field(default_factory=list)
    gathered_scope: list[int] = dataclasses.field(default_factory=list)

    def _max(self, key) -> float:
        return max((key(p) for p in self.positions), default=0.0)

    @property
    def flops(self) -> float:
        return self._max(lambda p: p.flops)

    @property
    def matmul_flops(self) -> float:
        return self._max(lambda p: p.matmul_flops)

    @property
    def traffic_bytes(self) -> float:
        return self._max(lambda p: p.traffic_bytes)

    @property
    def peak_bytes(self) -> int:
        return int(self._max(lambda p: p.peak_bytes))

    @property
    def collectives(self) -> CollectiveStats:
        """The position with the most collective bytes."""
        if not self.positions:
            return PositionCounts().collectives
        return max((p.collectives for p in self.positions),
                   key=lambda c: c.total_bytes)

    def summary(self) -> str:
        c = self.collectives
        return (f"flops={self.flops:.3e} traffic={self.traffic_bytes:.3e}B "
                f"collective={c.total_bytes:.3e}B peak={self.peak_bytes:.3e}B "
                + " ".join(f"{k}:{v}" for k, v in c.counts.items() if v))


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _TagNodes(TorchFunctionMode):
    """Tags the autograd nodes an op creates (and any untagged node behind
    them: a custom Function's, a view's) with the current position."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_grad_enabled():
            pos = current_position()
            for t in _tensors(out):
                stack = [t.grad_fn]
                while stack:
                    node = stack.pop()
                    if node is None or "position" in node.metadata:
                        continue
                    node.metadata["position"] = pos
                    stack.extend(n for n, _ in node.next_functions)
        return out


class OpCounter(TorchDispatchMode):
    """Count what runs inside ``with OpCounter(n_positions) as c:``; then
    :meth:`analysis` gives the :class:`OpAnalysis`.  ``n_positions`` is
    the traced row's width (its tensor-parallel positions)."""

    def __init__(self, n_positions: int = 1, *, sample_micro: int = 0):
        super().__init__()
        self.pos = [PositionCounts() for _ in range(max(1, n_positions))]
        self.sample_micro = sample_micro
        #: how many times each op counts (see :func:`micro_batches`)
        self.weight = 1
        self.by_op: dict[str, dict] = defaultdict(
            lambda: {"calls": 0, "flops": 0.0, "traffic": 0.0})
        self.by_site: dict[tuple, dict] = defaultdict(
            lambda: {"calls": 0, "bytes": 0.0})
        self._live: dict[int, tuple[int, int]] = {}
        self._tagger = _TagNodes()
        #: see :func:`production` and :func:`scaled_live`
        self.share_fn: Callable | None = None
        self.live_scale = 1.0
        self.marks = GatherMarks()
        self._marks_before: GatherMarks | None = None

    # -- entering and leaving ------------------------------------------------
    def __enter__(self):
        global _ACTIVE, _MARKS
        if _ACTIVE is not None:
            raise RuntimeError("an OpCounter is already active")
        _ACTIVE = self
        self._marks_before, _MARKS = _MARKS, self.marks
        self._tagger.__enter__()
        try:
            return super().__enter__()
        except BaseException:
            self._tagger.__exit__(None, None, None)
            _ACTIVE, _MARKS = None, self._marks_before
            raise

    def __exit__(self, *exc):
        global _ACTIVE, _MARKS
        try:
            return super().__exit__(*exc)
        finally:
            self._tagger.__exit__(*exc)
            _ACTIVE, _MARKS = None, self._marks_before

    def _at(self, pos: int) -> PositionCounts:
        return self.pos[min(pos, len(self.pos) - 1)]

    # -- records -------------------------------------------------------------
    def add_collective(self, kind: str, nbytes: int, *, site: str = "",
                       position: int | None = None) -> None:
        if kind not in COLLECTIVES:
            raise ValueError(f"unknown collective {kind!r}")
        p = self._at(current_position() if position is None else position)
        w = self.weight
        b = w * (2.0 * nbytes if kind == "all-reduce" else float(nbytes))
        p.collectives.counts[kind] += w
        p.collectives.bytes_by_kind[kind] += b
        row = self.by_site[(kind, site)]
        row["calls"] += w
        row["bytes"] += b

    def add_kernel(self, name: str, cost: dict) -> None:
        p = self._at(current_position())
        w = self.weight
        p.flops += w * cost["flops"]
        p.traffic_bytes += w * cost["bytes"]
        row = self.by_op[f"kernel:{name}"]
        row["calls"] += w
        row["flops"] += w * cost["flops"]
        row["traffic"] += w * cost["bytes"]

    def _freed(self, key: int) -> None:
        nbytes, pos = self._live.pop(key, (0, 0))
        self._at(pos).live_bytes -= nbytes

    def _track(self, outs: list[torch.Tensor], ins: list[torch.Tensor],
               pos: int) -> None:
        """Count each new storage among ``outs`` live at ``pos`` until it
        is freed (an output that shares an input's storage is no new
        one)."""
        seen = {_storage_key(t) for t in ins}
        p = self._at(pos)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            seen.add(key)
            nbytes = int(st.nbytes() * self.live_scale)
            self._live[key] = (nbytes, pos)
            weakref.finalize(st, self._freed, key)
            p.live_bytes += nbytes
            p.peak_bytes = max(p.peak_bytes, p.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        pos = current_position()
        p = self._at(pos)
        outs = _tensors(out)
        ins = _tensors(args) + _tensors(kwargs)
        w = self.weight
        row = self.by_op[func.overloadpacket.__name__]
        row["calls"] += w
        if func.is_view or func in _NO_TRAFFIC:
            self._track(outs, ins, pos)
            return out
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            flops = w * float(formula(*args, **kwargs, out_val=out))
            p.flops += flops
            p.matmul_flops += flops
            row["flops"] += flops
        name = func.overloadpacket.__name__
        out_b = sum(tensor_bytes(t) for t in outs)
        if name in _GATHERS:
            traffic = 2 * min(out_b, sum(tensor_bytes(t) for t in ins))
        elif name in _SCATTERS:
            upd = [t for t in ins if t.dtype.is_floating_point]
            traffic = 2 * (tensor_bytes(upd[-1]) if upd else out_b)
        else:
            traffic = sum(tensor_bytes(t) for t in ins) + out_b
        traffic *= w
        p.traffic_bytes += traffic
        row["traffic"] += traffic
        self._track(outs, ins, pos)
        return out

    def analysis(self) -> OpAnalysis:
        n = max([len(self.pos), *(k + 1 for k in self.marks.peak)])
        peak, scope = self.marks.as_lists(n)
        return OpAnalysis(positions=self.pos, by_op=dict(self.by_op),
                          by_site=dict(self.by_site), gathered=peak,
                          gathered_scope=scope)
