"""Logical-axis sharding rules, the JAX package's ``parallel/sharding.py``
without JAX.

Tensors are described by *logical* axis names; a :class:`ShardingRules`
mapping resolves them to mesh axes.  The default mapping (DESIGN.md §5):

  batch        -> ("pod", "data")       data parallel over pods × data axis
  seq          -> "model"               sequence/context parallelism (activations)
  kv_seq       -> "model"               KV-cache sequence sharding (decode)
  kv_seq_long  -> ("data", "model")     500k decode, batch=1: shard KV everywhere
  heads        -> "model"               tensor parallel attention (when divisible)
  d_ff         -> "model"               tensor parallel MLP
  experts      -> "model" (if divisible) expert parallel
  vocab        -> "model"               sharded embedding/unembedding
  embed_fsdp   -> ("pod", "data")       parameter-storage sharding (ZeRO-3)
  ssm_heads    -> "model"               SSD head parallelism
  slots        -> "data"                serve: batch slots across device groups
  pages        -> "data"                serve: KV page pool across device groups

A rule resolving to an axis that does not divide the tensor dim is dropped
(replication) — divisibility-safe by construction.

A spec is a plain tuple, one entry a tensor dim (``None``, an axis name or
a tuple of axis names), trailing ``None``s stripped: the reference's
``PartitionSpec`` entries.  ``mesh`` is anything with a ``shape`` dict of
axis sizes (:class:`~repro_torch.serve.mesh.ServeMesh` is one).

Not ported: ``logical``, ``use_rules``/``current_rules``, ``named_sharding``
and ``param_specs_for_tree``, nor the rules' ``enable`` switch that only
``logical`` reads.  They put GSPMD sharding constraints on traced values
under an ambient rules context; the port runs eagerly, with no compiler to
constrain, and its serving engine places each shard on its device
explicitly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

__all__ = ["ShardingRules", "DEFAULT_RULES", "logical_spec"]


@dataclasses.dataclass
class ShardingRules:
    mesh: Any                # an object with a ``shape`` dict, or None
    rules: dict[str, Any]    # logical name -> mesh axis | tuple | None

    def axis_size(self, axis) -> int:
        if self.mesh is None or axis is None:
            return 1
        if isinstance(axis, (tuple, list)):
            n = 1
            for a in axis:
                n *= self.mesh.shape.get(a, 1)
            return n
        return self.mesh.shape.get(axis, 1)

    def spec_for(self, names: Sequence[str | None],
                 dims: Sequence[int] | None = None) -> tuple:
        """Resolve logical names to a spec tuple; drop non-dividing axes."""
        out = []
        used: set[str] = set()
        for i, name in enumerate(names):
            axis = self.rules.get(name) if name else None
            if axis is None:
                out.append(None)
                continue
            flat = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
            # drop axes absent from the mesh, already used, or non-dividing
            keep = []
            size = 1
            for a in flat:
                if a in used or (self.mesh and a not in self.mesh.shape):
                    continue
                s = self.mesh.shape.get(a, 1) if self.mesh else 1
                if dims is not None and dims[i] % (size * s) != 0:
                    continue
                keep.append(a)
                size *= s
            for a in keep:
                used.add(a)
            if not keep:
                out.append(None)
            elif len(keep) == 1:
                out.append(keep[0])
            else:
                out.append(tuple(keep))
        while out and out[-1] is None:
            out.pop()
        return tuple(out)


DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": "model",
    "dec_seq": None,
    "kv_seq": "model",
    "kv_seq_long": ("data", "model"),
    "heads": "model",
    "heads_flat": "model",
    "kv_heads": "model",
    "d_ff": "model",
    "ssm_inner": "model",
    "experts": "model",
    "moe_capacity": ("pod", "data"),
    "vocab": "model",
    "embed": None,
    "embed_fsdp": ("pod", "data"),
    "ssm_heads": "model",
    "ssm_state": None,
    "layers": None,
    # serve-side axes (DESIGN.md §13): batch slots and the paged KV pool
    # partition over the data axis (device groups); kv_heads above covers
    # tensor-parallel decode of the pool.
    "slots": "data",
    "pages": "data",
}


def logical_spec(names: Sequence[str | None], dims: Sequence[int],
                 rules: ShardingRules | None = None) -> tuple:
    """``rules.spec_for(names, dims)``; the empty spec without rules (the
    reference falls back to its ambient rules context, which the port does
    not have)."""
    if rules is None:
        return ()
    return rules.spec_for(names, dims)
