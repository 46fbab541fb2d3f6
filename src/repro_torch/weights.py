"""Parameters of the port: carried over from the JAX package, or drawn
afresh.

* :func:`from_jax_numpy` takes the reference's parameter pytree with numpy
  leaves (``jax.tree.map(np.asarray, params)`` — the caller does that; this
  module never imports JAX) and returns the port's layout: the layers that
  the reference stacks on a leading axis under ``params["groups"][0]``
  become one dict per layer.
* :func:`init_params` draws the same layout with the reference's
  truncated-normal scales from a ``torch.Generator`` — what runs on the card,
  where there is no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.config import ModelConfig
from .models.transformer import check_supported, init_params

__all__ = ["from_jax_numpy", "init_params"]


def _tensors(tree, device, index=None):
    if isinstance(tree, dict):
        return {k: _tensors(v, device, index) for k, v in tree.items()}
    arr = np.asarray(tree)
    if index is not None:
        arr = arr[index]
    return torch.tensor(arr, device=device)


def from_jax_numpy(params_np: dict, cfg: ModelConfig, device) -> dict:
    """Reference pytree (numpy leaves) -> the port's parameters on
    ``device``, values unchanged."""
    check_supported(cfg)
    groups, tail = params_np["groups"], params_np.get("tail", [])
    if len(groups) != 1 or tail:
        raise ValueError(f"expected one stacked layer group and no tail, got "
                         f"{len(groups)} group(s) and {len(tail)} tail block(s)")
    stacked = groups[0]
    n = np.asarray(stacked["ln1"]["scale"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"{n} stacked layers != cfg.n_layers {cfg.n_layers}")
    return {"embed": _tensors(params_np["embed"], device),
            "layers": [_tensors(stacked, device, i) for i in range(n)],
            "norm_f": _tensors(params_np["norm_f"], device)}
