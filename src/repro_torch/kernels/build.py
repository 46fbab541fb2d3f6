"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``src/repro_torch/csrc/`` compiles on its own into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes), for Hopper only (``sm_90a``).  Libraries land
in ``build/repro_torch/`` at the root of the checkout, named by a digest
of the source and the flags, so an edited source is never served a stale
library.  Nothing is built at import time: the first launch of a kernel
builds it, and :func:`build_all` starts one ``nvcc`` per source, all
together, for callers that want every kernel up front.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "BUILD_LOGS", "CSRC", "SOURCES", "build",
           "build_all", "library_path"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
#: kernel name -> source file under ``csrc/``
SOURCES = {"paged_attention": "paged_attention.cu",
           "ssd_scan": "ssd_scan.cu",
           "jacobi_sweep": "jacobi_sweep.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "rmsnorm": "rmsnorm.cu"}
#: kernel name -> the compiler's output of its last verbose build
BUILD_LOGS: dict[str, str] = {}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "/usr/local/cuda/bin): the port's CUDA kernels are "
                       "built on the machine with the card")


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives once built: named by the
    source, every header under ``csrc/`` and the flags."""
    data = (CSRC / SOURCES[name]).read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        data += header.read_bytes()
    digest = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=None, *, ptxas_verbose: bool = False) -> dict[str, Path]:
    """Build every kernel in ``names`` (default: all) that is not built yet,
    one ``nvcc`` process per source, all started together.  Returns
    ``{name: library path}``.  ``ptxas_verbose`` prints each kernel's
    register and shared-memory use (``-Xptxas -v``) and keeps the output
    in :data:`BUILD_LOGS`.  Raises with the
    compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {name: library_path(name) for name in names}
    procs = {}
    for name in names:
        if out[name].exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        if ptxas_verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        if ptxas_verbose and log:
            BUILD_LOGS[name] = log
            print(log, end="", flush=True)
        os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def build(name: str) -> Path:
    """Build (if needed) and return the library of kernel ``name``."""
    return build_all([name])[name]
