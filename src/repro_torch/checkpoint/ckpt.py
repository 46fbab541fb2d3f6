"""Sharded, async checkpointing of trees of tensors.

The reference's on-disk layout (``repro/checkpoint/ckpt.py``):
``<dir>/step_<N>/`` holds one ``.npz`` per shard group and a
``manifest.json`` (leaf paths, shapes, dtypes, shard file, sha256 of every
file).  Writes are atomic (tmp dir + rename) and the ``LATEST`` pointer is
written last, so a crash mid-write never corrupts the restore path — the
previous complete step stays live.  bf16 (which numpy lacks) is stored as
its raw bytes.  Restore reads on the host and places every tensor on the
device it is given, or, given a training mesh, by its specs on the mesh
(``parallel.partition.place_state``), in place of the reference's
``sharding_fn``.  A checkpoint holds whole leaves: a placed state is
saved through ``TrainState.tree()``, which gathers them.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from ..parallel.partition import place_state
from ..tree import tree_map, tree_paths

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer"]

#: dtypes numpy has no type for: stored as raw bytes, as the reference
#: stores bfloat16 and float8 leaves
_RAW = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}


def _host(leaf) -> torch.Tensor:
    return torch.as_tensor(leaf).detach().cpu()


def _snapshot(leaf) -> torch.Tensor:
    """A host copy that later in-place updates of ``leaf`` leave alone."""
    t = torch.as_tensor(leaf).detach()
    return t.cpu() if t.is_cuda else t.clone()


def save_checkpoint(directory: str, tree, step: int, *,
                    shard_groups: int = 1) -> str:
    """Write ``tree`` (nested dicts/lists of tensors) under
    ``directory/step_<step>``.  Returns the path."""
    flat = dict(tree_paths(tree))
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    keys = sorted(flat)
    groups: list[list[str]] = [[] for _ in range(max(1, shard_groups))]
    for i, k in enumerate(keys):
        groups[i % len(groups)].append(k)

    manifest = {"step": step, "files": {}, "leaves": {}}
    for gi, group in enumerate(groups):
        if not group:
            continue
        fname = f"shard_{gi:05d}.npz"
        arrs = {}
        for k in group:
            t = _host(flat[k])
            dtype = str(t.dtype).replace("torch.", "")
            raw = dtype in _RAW
            arrs[k] = (t.contiguous().view(torch.uint8).reshape(-1).numpy()
                       if raw else t.numpy())
            manifest["leaves"][k] = {"shape": list(t.shape), "dtype": dtype,
                                     "file": fname, "raw": raw}
        path = os.path.join(tmp, fname)
        np.savez(path, **arrs)
        with open(path, "rb") as f:
            manifest["files"][fname] = hashlib.sha256(f.read()).hexdigest()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    return final


def _scan_steps(directory: str) -> list[int]:
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    steps = []
    for d in names:
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                steps.append(int(d.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(directory: str) -> int | None:
    """Newest complete step.  Falls back to scanning ``step_*`` dirs when
    ``LATEST`` is missing, empty, or corrupt — a crash between the step-dir
    rename and the pointer update must not make the restore path raise."""
    p = os.path.join(directory, "LATEST")
    if os.path.exists(p):
        try:
            with open(p) as f:
                return int(f.read().strip())
        except (ValueError, OSError):
            pass
    steps = _scan_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, like, *, step: int | None = None,
                       device=None, mesh=None, verify: bool = True):
    """Restore into the structure of ``like`` (a tree of tensors or of
    placed leaves: each leaf gives the dtype, and the device unless
    ``device`` is given).  ``mesh``: ``like`` is a training state's tree
    (``{"params", "opt_state", "step"}``), and every leaf is placed on the
    mesh by its specs (on a 1 x 1 grid, put on its device), whatever mesh
    saved it.  Returns ``(tree, step)``."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    root = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    if verify:
        for fname, digest in manifest["files"].items():
            with open(os.path.join(root, fname), "rb") as f:
                actual = hashlib.sha256(f.read()).hexdigest()
            if actual != digest:
                raise IOError(f"checksum mismatch in {fname}")
    data: dict[str, torch.Tensor] = {}
    by_file: dict[str, list[str]] = {}
    for k, meta in manifest["leaves"].items():
        by_file.setdefault(meta["file"], []).append(k)
    for fname, ks in by_file.items():
        with np.load(os.path.join(root, fname)) as z:
            for k in ks:
                meta = manifest["leaves"][k]
                a = torch.from_numpy(np.array(z[k]))
                if meta.get("raw"):
                    a = a.view(_RAW[meta["dtype"]]).reshape(meta["shape"])
                data[k] = a

    missing = {k for k, _ in tree_paths(like)} - set(data)
    if missing:
        raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]} ...")
    paths = iter(k for k, _ in tree_paths(like))

    if mesh is not None:
        device = mesh.lead if mesh.size == 1 else torch.device("cpu")

    def place(leaf):
        t = data[next(paths)]
        dev = device if device is not None else getattr(leaf, "device", None)
        return t.to(device=dev, dtype=getattr(leaf, "dtype", t.dtype))
    tree = tree_map(place, like)
    return (tree if mesh is None else place_state(tree, mesh)), step


class AsyncCheckpointer:
    """Fire-and-forget checkpoint writes on a background thread (bounded to
    one in flight; the caller's tensors are copied to the host first so
    training can overwrite them immediately)."""

    def __init__(self, directory: str, *, shard_groups: int = 1,
                 keep: int = 3):
        self.directory = directory
        self.shard_groups = shard_groups
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, tree, step: int) -> None:
        self.wait()
        host_tree = tree_map(_snapshot, tree)

        def work():
            try:
                save_checkpoint(self.directory, host_tree, step,
                                shard_groups=self.shard_groups)
                self._gc()
            except Exception as e:  # pragma: no cover
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self) -> None:
        steps = _scan_steps(self.directory)
        # max(0, ...): keep=0 deletes everything, and fewer than ``keep``
        # checkpoints are all kept
        for s in steps[:max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
