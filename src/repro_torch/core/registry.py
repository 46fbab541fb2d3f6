"""User-function registration (paper §3.2).

The paper registers functions with signature::

    void function_name(FunctionData *input, FunctionData *output)

inside 'fat' workers before recompiling the framework.  Here a registered
function is a plain Python callable over tensors that maps input chunks to
output chunks (it writes into none of them).  Three kinds exist:

* ``chunkwise`` — ``fn(chunk) -> chunk``; applied to every input chunk
  independently.  This is the distributable kind: the framework splits the
  chunks over the job's instruction sequences, exactly the
  automatic data distribution of paper §2.2.  One output chunk per input
  chunk.
* ``whole``     — ``fn(ChunkedData) -> ChunkedData``; sees the assembled
  input, returns arbitrary chunks.  Used when the computation is not
  chunk-separable (e.g. the paper's global-max job J3 could be either).
* ``control``   — ``fn(ChunkedData, ControlContext) -> ChunkedData``; runs on
  the host and may *add dynamic jobs* through the context (paper §3.3's
  "each job can add a finite number of new jobs", used by the Jacobi
  convergence job).

Functions are looked up by integer id (paper) or by name (extension).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from .job import GraphValidationError, Job

__all__ = ["FunctionKind", "FunctionRegistry", "RegisteredFunction", "ControlContext"]


class FunctionKind:
    CHUNKWISE = "chunkwise"
    WHOLE = "whole"
    CONTROL = "control"


@dataclasses.dataclass
class RegisteredFunction:
    fid: int | str
    fn: Callable
    kind: str
    name: str = ""
    # multi-input chunkwise functions consume one chunk from each input ref
    # position per call (zip semantics); whole functions get a tuple of
    # ChunkedData, one per input ref.


class ControlContext:
    """Handed to control functions so they can enqueue dynamic jobs."""

    def __init__(self, graph, current_segment: int):
        self._graph = graph
        self.current_segment = current_segment
        self.added: list[tuple[Job, int]] = []

    def add_job(self, job: Job, segment_offset: int = 1) -> None:
        """Add ``job`` to the segment ``current + segment_offset``.

        ``segment_offset=0`` targets the *current* segment (allowed by the
        paper); negative offsets are rejected.
        """
        if segment_offset < 0:
            raise GraphValidationError("dynamic jobs cannot target completed segments")
        target = self.current_segment + segment_offset
        self.added.append((job, target))


class FunctionRegistry:
    def __init__(self):
        self._fns: dict[Any, RegisteredFunction] = {}

    def register(self, fid: int | str, fn: Callable, *,
                 kind: str = FunctionKind.CHUNKWISE, name: str = "") -> RegisteredFunction:
        if fid in self._fns:
            raise GraphValidationError(f"function id {fid!r} already registered")
        if kind not in (FunctionKind.CHUNKWISE, FunctionKind.WHOLE, FunctionKind.CONTROL):
            raise GraphValidationError(f"unknown function kind {kind!r}")
        rf = RegisteredFunction(fid=fid, fn=fn, kind=kind,
                                name=name or getattr(fn, "__name__", str(fid)))
        self._fns[fid] = rf
        return rf

    # decorator sugar ---------------------------------------------------------
    def chunkwise(self, fid):
        def deco(fn):
            self.register(fid, fn, kind=FunctionKind.CHUNKWISE)
            return fn
        return deco

    def whole(self, fid):
        def deco(fn):
            self.register(fid, fn, kind=FunctionKind.WHOLE)
            return fn
        return deco

    def control(self, fid):
        def deco(fn):
            self.register(fid, fn, kind=FunctionKind.CONTROL)
            return fn
        return deco

    def __contains__(self, fid):
        return fid in self._fns

    def __getitem__(self, fid) -> RegisteredFunction:
        try:
            return self._fns[fid]
        except KeyError:
            raise GraphValidationError(f"function id {fid!r} not registered") from None

    def ids(self):
        return list(self._fns)
