"""Parameters of the port: carried over from the JAX package, or drawn
afresh.

* :func:`from_jax_numpy` takes the reference's parameter pytree with numpy
  leaves (``jax.tree.map(np.asarray, params)`` — the caller does that; this
  module never imports JAX) and returns the port's layout: the layers that
  the reference stacks on a leading axis under ``params["groups"]`` (one
  stacked tree a position of the layer pattern) and the ``params["tail"]``
  blocks become one dict per layer, in the order ``layer_kinds`` gives;
  a hybrid model's ``params["shared"]`` block comes across as it is, and
  an encoder-decoder model's stacked ``enc_groups`` become
  ``params["enc_layers"]`` beside ``enc_norm_f``, ``enc_pos`` and
  ``dec_pos`` (its decoder blocks carry their ``cross`` leaves).
* :func:`train_state_from_jax_numpy` does the same for a reference
  ``TrainState`` (parameters, optimizer state, step), so a test can start
  both trainers from one state.
* :func:`init_params` draws the same layout with the reference's
  truncated-normal scales from a ``torch.Generator`` — what runs on the card,
  where there is no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.config import ModelConfig
from .models.transformer import check_supported, init_params, layer_plan
from .train.step import TrainState

__all__ = ["from_jax_numpy", "init_params", "train_state_from_jax_numpy"]


def _tensors(tree, device, index=None):
    if isinstance(tree, dict):
        return {k: _tensors(v, device, index) for k, v in tree.items()}
    arr = np.asarray(tree)
    if index is not None:
        arr = arr[index]
    if arr.dtype.name == "bfloat16":
        # numpy's bfloat16 (ml_dtypes) has no torch counterpart to read
        # from; the fp32 round trip is exact
        return torch.tensor(arr.astype(np.float32),
                            device=device).to(torch.bfloat16)
    return torch.tensor(arr, device=device)


def _unstack(tree_np: dict, cfg: ModelConfig, device) -> dict:
    """A params-shaped reference tree (its leaves may themselves be dicts of
    arrays, as Adafactor's state is) in the port's layout: group g of
    every pattern position, for g in order, then the tail blocks —
    ``pattern * n_groups + tail``.  A shared position's group entry is
    ``{}`` in both layouts."""
    plan = layer_plan(cfg)
    groups, tail = tree_np["groups"], tree_np.get("tail", [])
    if len(groups) != len(plan.pattern) or len(tail) != len(plan.tail):
        raise ValueError(f"expected {len(plan.pattern)} stacked group(s) and "
                         f"{len(plan.tail)} tail block(s), got {len(groups)} "
                         f"and {len(tail)}")
    out = {"embed": _tensors(tree_np["embed"], device),
           "layers": [_tensors(groups[i], device, g)
                      for g in range(plan.n_groups)
                      for i in range(len(plan.pattern))]
           + [_tensors(t, device) for t in tail],
           "norm_f": _tensors(tree_np["norm_f"], device)}
    if "shared" in tree_np:
        out["shared"] = _tensors(tree_np["shared"], device)
    if "enc_groups" in tree_np:
        (enc,) = tree_np["enc_groups"]       # the encoder's one-kind pattern
        out["enc_layers"] = [_tensors(enc, device, g)
                             for g in range(plan.enc_groups)]
        for key in ("enc_norm_f", "enc_pos", "dec_pos"):
            out[key] = _tensors(tree_np[key], device)
    return out


def from_jax_numpy(params_np: dict, cfg: ModelConfig, device) -> dict:
    """Reference pytree (numpy leaves) -> the port's parameters on
    ``device``, values unchanged."""
    check_supported(cfg)
    n = np.asarray(params_np["groups"][0]["ln1"]["scale"]).shape[0]
    if n != layer_plan(cfg).n_groups:
        raise ValueError(f"{n} stacked groups != the plan's "
                         f"{layer_plan(cfg).n_groups}")
    return _unstack(params_np, cfg, device)


def train_state_from_jax_numpy(state_np: dict, cfg: ModelConfig, device):
    """A reference ``TrainState`` as ``{"params", "opt_state", "step"}``
    with numpy leaves -> the port's ``TrainState`` on ``device``.  The
    optimizer state keeps its kind's layout: AdamW ``{"m", "v", "count"}``
    (m and v params-shaped), Adafactor ``{"f", "count"}``, SGD
    ``{"count"}``."""
    opt_np = state_np["opt_state"]
    opt = {"count": torch.tensor(np.asarray(opt_np["count"]), device=device)}
    for key in ("m", "v", "f"):
        if key in opt_np:
            opt[key] = _unstack(opt_np[key], cfg, device)
    return TrainState(params=from_jax_numpy(state_np["params"], cfg, device),
                      opt_state=opt, step=int(np.asarray(state_np["step"])))
