"""Worker-process entry point for :class:`repro_torch.core.procworker.ProcessExecutor`.

Runs inside a ``multiprocessing`` *spawn* child — the paper's 'fat worker'
that "registers functions before recompiling the framework": the child
resolves its function table from a ``"module:attr"`` spec at startup and
never sees the master's registry (whose functions may close over tensors
and device handles that don't pickle).

The child touches no device on its own: whatever a function table needs
(a CUDA context, the kernel libraries) it sets up inside its functions, on
their first call.

Protocol (one request/response pair in flight per worker — the master's
per-worker dispatch queues already serialise placements per worker), over
two one-way pipes:

    ("job", seq, key, fid, kind, specs) + arrays  →  ("ok", seq, key, specs)
                                                     + arrays
                                                  |  ("err", seq, key, traceback)
    ("stop",)                                     →  child exits

A message is a small pickled header; the arrays it lists follow as raw
bytes, written from and read into their numpy buffers (:func:`send_arrays`,
:func:`recv_arrays`) — no pickling of the data, which at full model width
is gigabytes a job.  ``specs`` mirror the arrays as ``(dtype, shape)``
pairs: one list per input ref on a request (``kind`` "chunkwise" applies
fn per zipped chunk tuple, "whole" calls it on the full chunk lists), one
flat list on a reply.  Arrays are in the store's canonical form
(:func:`~repro_torch.core.store.to_numpy`), on both sides of the boundary.
The result is persisted to the :class:`JobStore` **before** the reply is
sent — a master that dies between child completion and reply delivery
still finds the row ``done`` on resume.
"""
from __future__ import annotations

import fcntl
import importlib
import os
import threading
import traceback

import numpy as np

from .store import JobStore, to_numpy

__all__ = ["array_specs", "recv_arrays", "resolve_fns", "send_arrays",
           "widen_pipe", "worker_main"]

#: pipe capacity asked for (Linux; the default 64 KiB means a system call
#: per 64 KiB of a multi-gigabyte transfer)
PIPE_BYTES = 1 << 20


def widen_pipe(conn) -> None:
    """Ask the kernel for a :data:`PIPE_BYTES` pipe behind ``conn``."""
    try:
        fcntl.fcntl(conn.fileno(), fcntl.F_SETPIPE_SZ, PIPE_BYTES)
    except (AttributeError, OSError):
        pass                      # another OS, or above the system's limit


def array_specs(arrays) -> list[tuple[str, tuple[int, ...]]]:
    return [(a.dtype.str, a.shape) for a in arrays]


def _raw(a: np.ndarray) -> memoryview:
    return memoryview(a.reshape(-1).view(np.uint8))


def send_arrays(conn, arrays) -> None:
    """Write each (C-contiguous) array's bytes to ``conn``'s pipe."""
    fd = conn.fileno()
    for a in arrays:
        mv = _raw(a)
        while mv.nbytes:
            mv = mv[os.write(fd, mv):]


def recv_arrays(conn, specs) -> list[np.ndarray]:
    """Read the arrays ``specs`` describe from ``conn``'s pipe, each
    straight into a fresh buffer.  Raises ``EOFError`` if the writer
    went away."""
    fd = conn.fileno()
    out = []
    for dtype, shape in specs:
        a = np.empty(shape, np.dtype(dtype))
        mv = _raw(a)
        while mv.nbytes:
            n = os.readv(fd, [mv])
            if n == 0:
                raise EOFError("pipe closed mid-array")
            mv = mv[n:]
        out.append(a)
    return out


def resolve_fns(spec: str) -> dict:
    """``"package.module:ATTR"`` → the module-level function table (a dict
    mapping registry fid strings to plain functions)."""
    modname, _, attr = spec.partition(":")
    if not attr:
        raise ValueError(f"worker fn spec {spec!r} must be 'module:attr'")
    table = getattr(importlib.import_module(modname), attr)
    if not isinstance(table, dict):
        raise TypeError(f"{spec} must resolve to a dict, got {type(table)}")
    return table


def _run_job(fn, kind: str, inputs: list[list[np.ndarray]]) -> list[np.ndarray]:
    if kind == "chunkwise":
        return [to_numpy(fn(*args)) for args in zip(*inputs)]
    out = fn(*inputs)  # whole: fn sees every input's full chunk list
    if isinstance(out, (list, tuple)):
        return [to_numpy(a) for a in out]
    return [to_numpy(out)]


def worker_main(wid: int, store_path: str, fns_spec: str,
                hb_interval: float, req, resp) -> None:
    fns = resolve_fns(fns_spec)
    store = JobStore(store_path)
    store.register_worker(wid, os.getpid())
    stop = threading.Event()

    def _beat() -> None:
        while not stop.wait(hb_interval):
            store.beat(wid)

    beater = threading.Thread(target=_beat, daemon=True,
                              name=f"proc-w{wid}-beat")
    beater.start()
    try:
        while True:
            try:
                msg = req.recv()
            except EOFError:          # the master went away
                break
            if msg[0] == "stop":
                break
            _, seq, key, fid, kind, specs = msg
            inputs = [recv_arrays(req, s) for s in specs]
            try:
                arrays = _run_job(fns[fid], kind, inputs)
                # durable BEFORE the reply: the master may die in between
                store.put_result(key, arrays, fn=str(fid), worker=wid)
            except Exception:
                resp.send(("err", seq, key, traceback.format_exc()))
                continue
            resp.send(("ok", seq, key, array_specs(arrays)))
            send_arrays(resp, arrays)
    finally:
        stop.set()
        store.mark_worker_dead(wid)
        store.close()
