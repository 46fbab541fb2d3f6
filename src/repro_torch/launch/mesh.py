"""Device meshes, the JAX package's ``launch/mesh.py`` as a single
controller.

A :class:`DeviceMesh` is a grid of ``torch.device``\\ s over named axes
(``("data", "model")``, ``("pod", "data", "model")`` or ``("data",)``),
all driven by one process: the training step (``train/step.py``), the
serving engine (``serve/mesh.py``, whose :class:`~repro_torch.serve.mesh.
ServeMesh` is this grid with serving's ``(dp, tp)`` accessors) and the
``SpmdExecutor`` take it.  Position k of the grid is its k-th device in
row-major order; position 0 is the *lead*.

The grid may repeat a device: a machine with one card runs a 2 x 2 mesh by
``devices=[torch.device("cuda:0")] * 4``.  On the CPU every position is
the CPU, as the reference's forced host devices share one CPU.  A CUDA
mesh with more positions than visible cards raises unless ``devices=`` is
given; there is no fallback to the CPU.

A ``meta`` grid (``device="meta"``) places every position on PyTorch's
meta device: tensors with shapes and no memory, the counterpart of the
reference's forced host devices in its dry-run.
:func:`make_production_mesh` gives the production grids (16 x 16 and
2 x 16 x 16) on it, for ``launch/dryrun.py`` and its tools.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

import torch

__all__ = ["DeviceMesh", "compat_make_mesh", "make_production_mesh",
           "make_test_mesh", "grid_devices"]


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A grid of devices over named axes: ``devices`` nests one tuple an
    axis (row-major), ``axis_names`` names them outermost first."""

    devices: tuple
    axis_names: tuple[str, ...]

    @property
    def dims(self) -> tuple[int, ...]:
        dims, level = [], self.devices
        for _ in self.axis_names:
            dims.append(len(level))
            level = level[0]
        return tuple(dims)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    @property
    def flat(self) -> tuple[torch.device, ...]:
        """Every position's device, row-major."""
        out = self.devices
        for _ in self.axis_names[1:]:
            out = tuple(d for sub in out for d in sub)
        return out

    @property
    def lead(self) -> torch.device:
        return self.flat[0]

    def coords(self) -> list[dict[str, int]]:
        """Every position's coordinates, row-major."""
        return [dict(zip(self.axis_names, c))
                for c in itertools.product(*(range(n) for n in self.dims))]

    def unique_devices(self) -> list[torch.device]:
        """Every device of the grid once, in grid order."""
        return list(dict.fromkeys(self.flat))

    def rows(self) -> list[list[int]]:
        """The positions of each data row, row-major over the axes other
        than ``"model"``: a row's positions differ only on ``"model"``
        (its tensor-parallel positions), its first is the row's lead.
        Without a ``"model"`` axis every position is a row."""
        rows: dict[tuple, list[int]] = {}
        for k, c in enumerate(self.coords()):
            key = tuple(v for a, v in c.items() if a != "model")
            rows.setdefault(key, []).append(k)
        return list(rows.values())


def grid_devices(size: int, *, device="cuda", devices: Sequence | None = None,
                 label: str = "") -> list[torch.device]:
    """``size`` devices for a grid's positions, row-major: ``devices``
    (``size`` entries; a device may repeat) when given, else ``cuda:0 …
    cuda:{size-1}`` for ``device="cuda"``, and the CPU or the meta device
    (placeholders: shapes, no memory) at every position for ``device="cpu"``
    or ``"meta"``.  A CUDA grid raises where there are fewer CUDA devices
    than positions, and on a CUDA device that is not there."""
    what = f"mesh {label}" if label else "mesh"
    if devices is None:
        kind = torch.device(device).type
        if kind in ("cpu", "meta"):
            devices = [torch.device(kind)] * size
        elif kind == "cuda":
            n_dev = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if size > n_dev:
                raise ValueError(
                    f"{what} needs {size} CUDA devices, {n_dev} visible — "
                    f"pass devices= (a device may repeat: "
                    f"[torch.device('cuda:0')] * {size} runs the mesh on "
                    f"one card)")
            devices = [torch.device("cuda", i) for i in range(size)]
        else:
            raise ValueError(f"device {device!r}: a mesh runs on 'cuda', "
                             f"'cpu' or 'meta'")
    devices = [torch.device(d) for d in devices]
    if len(devices) != size:
        raise ValueError(f"{what} needs {size} devices, got {len(devices)}")
    for d in devices:
        if d.type == "cuda" and not (torch.cuda.is_available()
                                     and (d.index or 0)
                                     < torch.cuda.device_count()):
            raise ValueError(f"mesh device {d} is not available")
    return devices


def _nest(flat: list, dims: Sequence[int]) -> tuple:
    if len(dims) == 1:
        return tuple(flat)
    step = len(flat) // dims[0]
    return tuple(_nest(flat[i * step:(i + 1) * step], dims[1:])
                 for i in range(dims[0]))


def compat_make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
                     device="cuda", devices: Sequence | None = None
                     ) -> DeviceMesh:
    """The grid of ``shape`` over ``axis_names`` (the reference's
    ``jax.make_mesh``), its devices from :func:`grid_devices`."""
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or not shape or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} over axes {axis_names}")
    flat = grid_devices(math.prod(shape), device=device, devices=devices,
                        label="x".join(map(str, shape)))
    return DeviceMesh(devices=_nest(flat, shape), axis_names=axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production grid on meta devices: 16 x 16 over ``("data",
    "model")``, or 2 x 16 x 16 over ``("pod", "data", "model")`` with
    ``multi_pod`` (the ``pod`` axis the outer data axis)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes, device="meta")


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 1, *,
                   device="cpu", devices: Sequence | None = None
                   ) -> DeviceMesh:
    """A small ``("data", "model")`` mesh (``("pod", "data", "model")``
    with ``pod`` > 1), on the CPU unless told otherwise."""
    if pod > 1:
        return compat_make_mesh((pod, data, model), ("pod", "data", "model"),
                                device=device, devices=devices)
    return compat_make_mesh((data, model), ("data", "model"), device=device,
                            devices=devices)
