"""Job model of Mundani et al. — segments, jobs, chunks, dependencies.

The paper (§2.1) defines:

* an *algorithm* = ordered list of parallel segments ``S_1 .. S_n``,
* a *parallel segment* = set of jobs that may all execute concurrently; the
  segment completes when all its jobs have terminated (a barrier),
* a *job* = set of instruction sequences; sequences may run concurrently
  inside the job; the job completes when all sequences have terminated,
* dependencies are expressed as "job J_i consumes (chunks of) the results of
  job J_j" (``R1[0..5]`` in the paper's job-file syntax, §3.3).

In PyTorch a chunk is a tensor on an explicit device; a *sequence of
instructions* maps to a slice of the job's chunk axis, and the framework
derives data distribution from the declared chunking, exactly as the
paper's framework distributes chunks over a job's sequences.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

import numpy as np
import torch

__all__ = [
    "DataChunk",
    "ChunkedData",
    "ChunkRef",
    "Job",
    "ParallelSegment",
    "JobGraph",
    "GraphValidationError",
]


class GraphValidationError(ValueError):
    """A job graph violates the paper's structural rules."""


# ---------------------------------------------------------------------------
# Data chunks (paper §2.2, §3.2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DataChunk:
    """One consecutive memory location holding ``n_elem`` elements.

    Paper: ``DataChunk(MPI type datatype, int n_elem, void *data)``; the
    constructor *copies the pointer, not the data* — ownership moves to the
    framework.  A tensor is kept as it is (no copy, same device); anything
    else (numpy arrays, Python scalars) becomes a tensor on the CPU.  The
    framework never writes into a chunk, so aliasing the caller's buffer is
    safe.
    """

    data: Any  # torch.Tensor
    dtype: Any = None
    n_elem: int = -1

    def __post_init__(self):
        if not isinstance(self.data, torch.Tensor):
            self.data = torch.as_tensor(self.data)
        if self.dtype is None:
            self.dtype = self.data.dtype
        if self.n_elem < 0:
            self.n_elem = self.data.numel()
        # cached: queried per placement candidate on the dispatch hot path
        itemsize = (self.dtype.itemsize if isinstance(self.dtype, torch.dtype)
                    else np.dtype(self.dtype).itemsize)
        self._nbytes = int(itemsize) * self.n_elem

    @property
    def nbytes(self) -> int:
        return self._nbytes


class ChunkedData:
    """Paper's ``FunctionData``: an ordered collection of data chunks.

    Every job input/output is a ``ChunkedData``.  The chunk axis is the unit
    of automatic distribution: the framework splits chunks over the job's
    instruction sequences.
    """

    def __init__(self, chunks: Iterable[DataChunk] | None = None):
        self._chunks: list[DataChunk] = list(chunks or [])

    # -- paper-faithful accessors ------------------------------------------------
    def push_back(self, chunk: DataChunk) -> None:
        self._chunks.append(chunk)

    def get_data_chunk(self, i: int) -> DataChunk:
        return self._chunks[i]

    def n_chunks(self) -> int:
        return len(self._chunks)

    # -- pythonic accessors --------------------------------------------------
    def __len__(self) -> int:
        return len(self._chunks)

    def __iter__(self):
        return iter(self._chunks)

    def __getitem__(self, sel):
        if isinstance(sel, slice):
            return ChunkedData(self._chunks[sel])
        return self._chunks[sel]

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self._chunks)

    # -- conversion helpers ----------------------------------------------------
    @classmethod
    def from_array(cls, arr, n_chunks: int) -> "ChunkedData":
        """Split ``arr`` along its leading axis into ``n_chunks`` chunks.

        This is the paper's "input data … has to be given in amount of
        chunks" requirement (§2.2).  Uneven splits follow ``np.array_split``
        semantics (first chunks one element larger).  Chunks are views of
        ``arr`` on its device.
        """
        arr = torch.as_tensor(arr)
        if n_chunks < 1:
            raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
        if arr.dim() == 0:
            raise ValueError("cannot chunk a scalar")
        bounds = np.array_split(np.arange(arr.shape[0]), n_chunks)
        return cls([DataChunk(arr[b[0]:b[-1] + 1]) for b in bounds if b.size])

    @classmethod
    def from_arrays(cls, arrs: Iterable[Any]) -> "ChunkedData":
        return cls([DataChunk(a) for a in arrs])

    def to_array(self):
        """Concatenate all chunks along the leading axis."""
        if not self._chunks:
            raise ValueError("empty ChunkedData")
        if len(self._chunks) == 1:
            return self._chunks[0].data
        return torch.cat([torch.atleast_1d(c.data) for c in self._chunks],
                         dim=0)

    def arrays(self) -> list[Any]:
        return [c.data for c in self._chunks]


# ---------------------------------------------------------------------------
# Dependencies (paper §3.3 — "R1[0..5]" etc.)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChunkRef:
    """Reference to (a slice of) another job's result chunks.

    ``ChunkRef("J1")``          — all chunks of J1's result (paper: ``R1``)
    ``ChunkRef("J1", 0, 5)``    — chunks [0, 5) of J1's result (paper: ``R1[0..5]``)
    """

    job: str
    lo: int | None = None
    hi: int | None = None

    @property
    def whole(self) -> bool:
        return self.lo is None

    def select(self, data: ChunkedData) -> ChunkedData:
        if self.whole:
            return data
        if self.hi > data.n_chunks() or self.lo < 0 or self.lo >= self.hi:
            raise GraphValidationError(
                f"{self}: selection out of range for {data.n_chunks()} chunks")
        return data[self.lo:self.hi]

    def __repr__(self):
        base = f"R{self.job[1:]}" if self.job.startswith("J") else f"R({self.job})"
        return base if self.whole else f"{base}[{self.lo}..{self.hi}]"


# ---------------------------------------------------------------------------
# Jobs & segments (paper §2.2, §3.3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Job:
    """A schedulable unit (paper §3.3 job definition, four arguments).

    ``fn``            — function identifier registered with the framework
    ``n_threads``     — 0 ⇒ as many as the worker has cores (paper);
                        k>0 ⇒ exactly k lanes of intra-job parallelism.
    ``inputs``        — ChunkRefs to other jobs' results and/or bound data
    ``no_send_back``  — paper's optional 4th argument: results stay on the
                        worker (device-local), only a completion message is
                        sent to the scheduler.
    ``cost_hint``     — estimated useful FLOPs of one execution; consumed by
                        the cost-model placement strategy.  0.0 ⇒ unknown
                        (the scheduler falls back to a bytes-based bound).
    """

    name: str
    fn: int | str
    n_threads: int = 0
    inputs: tuple[ChunkRef, ...] = ()
    no_send_back: bool = False
    cost_hint: float = 0.0
    # runtime metadata (not part of the paper's definition)
    segment: int = -1

    def __post_init__(self):
        if self.n_threads < 0:
            raise GraphValidationError(f"{self.name}: n_threads must be >= 0")
        self.inputs = tuple(self.inputs)

    def deps(self) -> tuple[str, ...]:
        return tuple(ref.job for ref in self.inputs)


@dataclasses.dataclass
class ParallelSegment:
    """Set of jobs that may all execute concurrently (paper §2.1)."""

    jobs: list[Job] = dataclasses.field(default_factory=list)

    def __iter__(self):
        return iter(self.jobs)

    def __len__(self):
        return len(self.jobs)

    def names(self) -> list[str]:
        return [j.name for j in self.jobs]


class JobGraph:
    """The algorithm: an ordered list of parallel segments.

    Structural rules enforced (paper §2.1/§3.3):
      * job names unique,
      * a job may only consume results of jobs in *earlier* segments
        (within-segment jobs are concurrent, so same-segment reads race),
      * dynamic additions (``add_dynamic``) may target the current or any
        following segment, never a completed one.
    """

    def __init__(self, segments: Iterable[ParallelSegment] | None = None):
        self.segments: list[ParallelSegment] = list(segments or [])
        self.bound_inputs: dict[str, ChunkedData] = {}
        self._reindex()
        self.validate()

    # -- construction -----------------------------------------------------------
    def add_segment(self, jobs: Sequence[Job] | ParallelSegment) -> int:
        seg = jobs if isinstance(jobs, ParallelSegment) else ParallelSegment(list(jobs))
        idx = len(self.segments)
        self.segments.append(seg)
        # incremental index + validation (graphs grow to thousands of jobs
        # in iterative workloads; full revalidation would be O(n^2))
        for job in seg.jobs:
            if job.name in self._by_name:
                self.segments.pop()
                raise GraphValidationError(f"duplicate job name {job.name}")
            job.segment = idx
            self._by_name[job.name] = job
        try:
            for job in seg.jobs:
                self._validate_job(job)
        except GraphValidationError:
            for job in seg.jobs:
                del self._by_name[job.name]
            self.segments.pop()
            raise
        return idx

    def bind_input(self, job_name: str, data: ChunkedData | Any, n_chunks: int | None = None) -> None:
        """Attach initial input data to a job (the paper's example feeds the
        array ``A`` as k chunks into J1/J2)."""
        if not isinstance(data, ChunkedData):
            if n_chunks is None:
                raise ValueError("n_chunks required when binding a raw array")
            data = ChunkedData.from_array(data, n_chunks)
        self.bound_inputs[job_name] = data

    def add_dynamic(self, job: Job, segment_index: int, *, current: int) -> None:
        """Paper §3.3: during runtime each job can add a finite number of new
        jobs to the current or following parallel segments."""
        if segment_index < current:
            raise GraphValidationError(
                f"dynamic job {job.name} targets completed segment {segment_index} (current={current})")
        if job.name in self._by_name:
            raise GraphValidationError(f"duplicate job name {job.name}")
        while len(self.segments) <= segment_index:
            self.segments.append(ParallelSegment())
        job.segment = segment_index
        self.segments[segment_index].jobs.append(job)
        self._by_name[job.name] = job
        self._validate_job(job)

    def remove_job(self, name: str) -> Job:
        """Retire a dynamic job from the graph (serving-time GC, or a
        preempted request's job returning to the master queue).

        Removal is only legal when no remaining job consumes the retired
        job's results.  The name becomes reusable."""
        job = self._by_name.get(name)
        if job is None:
            raise GraphValidationError(f"cannot remove unknown job {name}")
        consumers = [j.name for j in self.jobs()
                     if name in j.deps() and j.name != name]
        if consumers:
            raise GraphValidationError(
                f"cannot remove {name}: still consumed by {consumers}")
        self.segments[job.segment].jobs.remove(job)
        del self._by_name[name]
        self.bound_inputs.pop(name, None)
        return job

    # -- introspection ----------------------------------------------------------
    def job(self, name: str) -> Job:
        return self._by_name[name]

    def jobs(self) -> Iterable[Job]:
        for seg in self.segments:
            yield from seg.jobs

    def names(self) -> list[str]:
        return [j.name for j in self.jobs()]

    def n_jobs(self) -> int:
        """O(1) total job count (the executor polls this per segment;
        scanning every segment would be O(segments²) over a run)."""
        return len(self._by_name)

    def segment_of(self, name: str) -> int:
        return self._by_name[name].segment

    def consumers(self, name: str) -> list[Job]:
        return [j for j in self.jobs() if name in j.deps()]

    def is_hybrid(self) -> tuple[bool, str]:
        """Classify per paper §2.1: strict / loose / not hybrid.

        Strict: some segment has >1 job AND one of *its* jobs has >1 sequence
        (n_threads != 1).  Loose: both conditions hold but in different
        segments.
        """
        multi_job = [i for i, s in enumerate(self.segments) if len(s) > 1]
        multi_seq = [i for i, s in enumerate(self.segments)
                     if any(j.n_threads != 1 for j in s)]
        strict = [i for i in multi_job
                  if any(j.n_threads != 1 for j in self.segments[i])]
        if strict:
            return True, "strict"
        if multi_job and multi_seq:
            return True, "loose"
        return False, "sequential"

    # -- validation --------------------------------------------------------------
    def _reindex(self) -> None:
        self._by_name: dict[str, Job] = {}
        for i, seg in enumerate(self.segments):
            for job in seg.jobs:
                job.segment = i
                if job.name in self._by_name:
                    raise GraphValidationError(f"duplicate job name {job.name}")
                self._by_name[job.name] = job

    def _validate_job(self, job: Job) -> None:
        for ref in job.inputs:
            if ref.job not in self._by_name:
                raise GraphValidationError(
                    f"{job.name} depends on unknown job {ref.job}")
            dep = self._by_name[ref.job]
            if dep.segment >= job.segment:
                raise GraphValidationError(
                    f"{job.name} (segment {job.segment}) depends on {ref.job} "
                    f"(segment {dep.segment}); dependencies must come from "
                    f"earlier segments")

    def validate(self) -> None:
        for job in self.jobs():
            self._validate_job(job)

    def __repr__(self):
        lines = []
        for i, seg in enumerate(self.segments):
            lines.append(f"S{i}: " + ", ".join(
                f"{j.name}(fn={j.fn},t={j.n_threads},in={list(j.inputs)},"
                f"nsb={j.no_send_back})" for j in seg.jobs))
        return "JobGraph[\n  " + "\n  ".join(lines) + "\n]"
