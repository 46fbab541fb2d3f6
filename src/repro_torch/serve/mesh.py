"""Serve-side device mesh and paged-cache sharding (DESIGN.md §13), the JAX
package's ``serve/mesh.py`` as a single controller.

One :class:`~repro_torch.serve.engine.PagedEngine` spans a ``(dp, tp)``
grid of ``torch.device``\\ s over the axes ``("data", "model")``, all
driven by one process:

* **tensor parallel** (``"model"`` axis) — the KV page pools shard over
  their ``kv_heads`` axis, so one model replica's decode splits per-KV-head
  attention across the row's positions (GQA groups stay on one position;
  only the output projection reduces, a sum of the partial outputs in
  position order on the row's lead position, ``grid[r][0]``).  This is TP
  of the cache and the attention compute: the norms, MLPs, experts, SSM
  layers, embedding and unembedding run once a row, on its lead, where the
  reference keeps them replicated.
* **data parallel** (``"data"`` axis) — batch slots and the page pool
  partition over the rows.  Row ``r`` holds the slots and the usable page
  range the scheduler's device group ``r`` owns (``np.array_split`` of
  both, as :class:`~repro_torch.serve.scheduler.ServeScheduler` splits
  them), so allocation, prefix caching, COW and preemption never cross a
  row.

Page layout under DP, a deviation from the reference: its pool splits dim 0
evenly over ``data``, which does not follow the groups' page ranges (GSPMD
gathers across the boundary; an eager port cannot).  Here row ``r``'s pools
hold exactly its group's range ``[lo, hi)`` plus a local trash page at
local index 0: global page ``p`` is local ``p - lo + 1``, page 0 is 0.  So
a row's pool bytes differ from the reference's even split under DP; under
TP they are the reference's exactly.

``kv_heads`` that ``tp`` does not divide is not split (``spec_for`` drops
the axis, as the reference replicates): the row's lead holds the whole pool
and runs every head, and the row's other positions hold nothing.

The grid may repeat a device: a machine with one card runs TP and DP by
``devices=[torch.device("cuda:0")] * size``.  A ``PagedEngine`` without a
mesh runs the same code on the 1 x 1 grid of its device
(:func:`local_mesh`): one row, one shard holding every head on the
weights' own storage, and no reduction.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..launch.mesh import DeviceMesh, grid_devices
from ..models.attention import split_attention
from ..models.config import ModelConfig
from ..models.layers import cast_weights, dtype_of
from ..models.transformer import (AttnShard, _blocks, init_paged_cache,
                                  paged_pools)
from ..parallel.sharding import DEFAULT_RULES, ShardingRules
from ..tree import tree_map

__all__ = ["MeshSpec", "ServeMesh", "MeshRow", "build_serve_mesh",
           "local_mesh", "serve_rules", "row_ranges", "kv_head_split", "shard_params",
           "shard_paged_cache", "per_device_pool_bytes"]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Parsed ``--mesh TP,DP``: tensor-parallel × data-parallel extents."""

    tp: int = 1
    dp: int = 1

    @property
    def size(self) -> int:
        return self.tp * self.dp

    @classmethod
    def parse(cls, text: str) -> "MeshSpec":
        parts = [p.strip() for p in str(text).split(",")]
        if len(parts) != 2:
            raise ValueError(f"--mesh wants 'TP,DP' (e.g. '2,1'), got "
                             f"{text!r}")
        try:
            tp, dp = int(parts[0]), int(parts[1])
        except ValueError:
            raise ValueError(f"--mesh wants two integers 'TP,DP', got "
                             f"{text!r}") from None
        if tp < 1 or dp < 1:
            raise ValueError(f"mesh extents must be >= 1, got tp={tp} dp={dp}")
        return cls(tp=tp, dp=dp)


@dataclasses.dataclass(frozen=True)
class ServeMesh(DeviceMesh):
    """A ``(dp, tp)`` grid of devices over the axes ``("data", "model")``
    (a :class:`~repro_torch.launch.mesh.DeviceMesh`): ``devices[r][i]`` is
    data row r's tensor-parallel position i."""

    axis_names: tuple[str, str] = ("data", "model")

    @property
    def spec(self) -> MeshSpec:
        return MeshSpec(tp=len(self.devices[0]), dp=len(self.devices))


def build_serve_mesh(spec: MeshSpec, *, device="cuda",
                     devices: Sequence | None = None) -> ServeMesh:
    """The ``(dp, tp)`` grid of ``spec``: ``devices`` (``spec.size``
    entries, row-major: row r is ``devices[r*tp:(r+1)*tp]``; a device may
    repeat) when given, else ``cuda:0 … cuda:{size-1}`` for
    ``device="cuda"`` and the CPU at every position for ``device="cpu"``
    (the reference's forced host devices share one CPU too).  A CUDA mesh
    raises where there are fewer CUDA devices than positions — there is no
    fallback to the CPU (:func:`~repro_torch.launch.mesh.grid_devices`)."""
    devices = grid_devices(spec.size, device=device, devices=devices,
                           label=f"{spec.tp}x{spec.dp}")
    grid = tuple(tuple(devices[r * spec.tp:(r + 1) * spec.tp])
                 for r in range(spec.dp))
    return ServeMesh(devices=grid)


def local_mesh(device) -> ServeMesh:
    """The 1 x 1 grid of one device: what a ``PagedEngine`` without a mesh
    runs on."""
    return ServeMesh(devices=((torch.device(device),),))


def serve_rules() -> dict:
    """Logical-axis rules for serving: DEFAULT_RULES already carries the
    serve axes (``kv_heads`` -> model, ``slots``/``pages`` -> data)."""
    return dict(DEFAULT_RULES)


def row_ranges(batch: int, num_pages: int, parts: int
               ) -> list[tuple[range, range]]:
    """``(slots, pages)`` of each of ``parts`` device groups — a serving
    mesh's data rows: the contiguous, as-even-as-possible split
    (``np.array_split``) of the slots and of the usable pages ``[1,
    num_pages)``, as ``ServeScheduler`` splits them.  A part may come out
    empty; the callers refuse that."""
    def split(lo: int, hi: int) -> list[range]:
        return [range(int(p[0]), int(p[-1]) + 1) if len(p) else range(lo, lo)
                for p in np.array_split(np.arange(lo, hi), parts)]
    return list(zip(split(0, batch), split(1, num_pages)))


def kv_head_split(cfg: ModelConfig, rules: ShardingRules, *,
                  num_pages: int, page_size: int) -> int:
    """How many tensor-parallel shards the pools ``(P, KV, ps, D)`` split
    into: the ``model`` extent when it divides KV, else 1 (the rule drops
    ``kv_heads``)."""
    spec = rules.spec_for(["pages", "kv_heads", None, None],
                          (num_pages, cfg.n_kv_heads, page_size, cfg.hd))
    return rules.axis_size(spec[1]) if len(spec) > 1 else 1


@dataclasses.dataclass
class MeshRow:
    """One data row of a serving mesh: its slots and global pages, its
    grid positions' devices (the first is its lead), the model's weights
    on the lead (without the attention weights when they are split: the
    shards hold them), its slots' cache (``len`` and the SSM state; the
    pools are the shards'), and its tensor-parallel shards (none for an
    attention-free model)."""

    slots: range
    pages: range
    devices: tuple[torch.device, ...]
    params: dict
    shards: list[AttnShard]
    cache: dict | None = None

    @property
    def device(self) -> torch.device:
        """The row's lead device."""
        return self.devices[0]

    def local_pages(self, ids) -> np.ndarray:
        """Global page ids (0 the trash page) as this row's local ids."""
        ids = np.asarray(ids, np.int32)
        return np.where(ids > 0, ids - self.pages.start + 1, 0).astype(
            np.int32)


def _to_device(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def shard_params(cfg: ModelConfig, params, mesh: ServeMesh, n_split: int
                 ) -> list[tuple[dict, list[AttnShard]]]:
    """Place the weights on the grid: each row's lead gets the model cast
    to the compute dtype, and each of the row's first ``n_split``
    positions an :class:`AttnShard` with its heads of every attention
    layer (``split_attention``; each invocation of a shared block is a
    layer) and no pools yet.  One shard (``n_split`` 1) holds the lead's
    attention weights themselves; split shards hold copies of their
    heads, and the lead's copy then keeps no attention weights.  Rows and
    positions on one device share one copy of the weights.  Returns
    ``(params, shards)`` a row."""
    dt = dtype_of(cfg.compute_dtype)
    by_device: dict = {}
    split: dict = {}
    out = []
    for row in mesh.devices:
        lead = row[0]
        if lead not in by_device:
            by_device[lead] = cast_weights(_to_device(params, lead), dt)
        row_params = by_device[lead]
        shards = []
        for i in range(n_split):
            dev = row[i]
            layers = []
            for kind, p in _blocks(cfg, row_params):
                if kind == "ssm":
                    continue
                key = (dev, i, id(p["attn"]))
                if key not in split:
                    cfg_s, p_s = split_attention(cfg, p["attn"], n_split, i)
                    split[key] = (cfg_s, _to_device(p_s, dev))
                layers.append(split[key][1])
            if layers:
                shards.append(AttnShard(split[key][0], dev, layers))
        out.append((row_params, shards))
    if n_split > 1:
        for row_params in by_device.values():
            for kind, p in _blocks(cfg, row_params):
                p.pop("attn", None)
    return out


def shard_paged_cache(cfg: ModelConfig, rows: list[MeshRow], *,
                      page_size: int) -> None:
    """Allocate each row's cache on its lead (``len`` and the SSM state
    of its slots) and each shard's zero page pools on its device: the
    row's page range plus its local trash page, the shard's KV heads."""
    for row in rows:
        n_pages = 1 + len(row.pages)
        row.cache = init_paged_cache(cfg, len(row.slots), num_pages=n_pages,
                                     page_size=page_size, device=row.device,
                                     pools=False)
        for sh in row.shards:
            pools = paged_pools(sh.cfg, num_pages=n_pages,
                                page_size=page_size, device=sh.device)
            sh.k, sh.v = pools["k"], pools["v"]


def per_device_pool_bytes(rows: list[MeshRow]) -> int:
    """The most attention-pool bytes any grid position holds — the
    per-device KV budget (TP=2 halves it when kv_heads divides, also where
    the positions share a card; one position holding everything gives the
    total)."""
    return max((sum(t.numel() * t.element_size() for t in (sh.k, sh.v))
                for row in rows for sh in row.shards), default=0)
