"""Spawn-side training function table for the process-worker runtime.

``ProcessExecutor`` children resolve their functions from a
``"module:attr"`` spec and never see the master's registry —
:class:`~repro_torch.train.hypar_loop.HyParTrainer`'s registered functions
are closures over the trainer instance and cannot cross a spawn boundary.
This module provides the same fids (``grad``/``opt``/``take_params``/
``take_opt``/``data``) as module-level functions computing what the
trainer's do, in the same order of operations: the master stages the model
config, the optimizer spec, the micro-batch keys and the compute device in
``REPRO_TORCH_TRAIN_PROCFNS`` (spawn children inherit the environment) via
:func:`export_env` **before** the executor starts its workers, and each
child rebuilds the parameter and optimizer-state structures locally from
``init_params`` on the ``meta`` device — structure only, no second model in
memory — whose leaf order is :mod:`repro_torch.tree`'s, the order the
master flattens in.

Leaves arrive as numpy arrays in the job store's canonical form and go to
the staged device (:func:`~repro_torch.serve.engine.resolve_device`: a
``cuda`` device must exist) on first use; the device and the CUDA context
are set up inside the functions, never at import, so resolving the table
stays cheap.  Gradients run through the model's default ``impl="auto"``:
on the card, the flash-attention forward and backward kernels.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

__all__ = ["FNS", "WORKER_FNS_SPEC", "ENV_KEY", "export_env"]

WORKER_FNS_SPEC = "repro_torch.train.procfns:FNS"
ENV_KEY = "REPRO_TORCH_TRAIN_PROCFNS"

_CTX = None


def export_env(cfg, spec, batch_keys, device="cuda") -> None:
    """Master side: stage the training setup for spawn children."""
    os.environ[ENV_KEY] = json.dumps({
        "cfg": dataclasses.asdict(cfg),
        "spec": dataclasses.asdict(spec),
        "batch_keys": sorted(batch_keys),
        "device": str(device),
    })


class _Ctx:
    def __init__(self):
        import torch

        from ..models.config import ModelConfig
        from ..models.transformer import init_params
        from ..optim import OptimizerSpec, init_opt_state
        from ..serve.engine import resolve_device
        from ..tree import tree_leaves, tree_map

        raw = os.environ.get(ENV_KEY)
        if not raw:
            raise RuntimeError(
                f"{ENV_KEY} is not set — the master must call "
                f"repro_torch.train.procfns.export_env(cfg, spec, batch_keys) "
                f"before spawning process workers")
        d = json.loads(raw)
        self.cfg = ModelConfig(**d["cfg"])
        self.spec = OptimizerSpec(**d["spec"])
        self.batch_keys = list(d["batch_keys"])
        self.device = resolve_device(d["device"])
        # structures from the master's init path, on the meta device: the
        # child only ever receives flat leaf lists, never trees
        params = init_params(self.cfg, torch.Generator(), "meta")
        opt = init_opt_state(self.spec, params)
        self.params_like = tree_map(lambda _: None, params)
        self.opt_like = tree_map(lambda _: None, opt)
        self.n_p = len(tree_leaves(params))

    def tensors(self, arrays) -> list:
        from ..core.store import from_numpy
        return [from_numpy(a).to(self.device) for a in arrays]


def _ctx() -> _Ctx:
    global _CTX
    if _CTX is None:
        _CTX = _Ctx()
    return _CTX


def grad(params_chunks, micro_chunks):
    from ..tree import tree_leaves, tree_unflatten
    from .step import compute_grads

    c = _ctx()
    params = tree_unflatten(c.params_like, c.tensors(params_chunks))
    batch = dict(zip(c.batch_keys, c.tensors(micro_chunks)))
    grads, _, _ = compute_grads(c.cfg, params, batch)
    return tree_leaves(grads)


def opt(params_chunks, opt_chunks, *grad_chunk_lists):
    from ..models.transformer import clip_groups
    from ..optim import opt_update
    from ..tree import tree_leaves, tree_unflatten

    c = _ctx()
    params = tree_unflatten(c.params_like, c.tensors(params_chunks))
    opt_state = tree_unflatten(c.opt_like, c.tensors(opt_chunks))
    grads_sum = None
    for gc in grad_chunk_lists:
        g = c.tensors(gc)
        grads_sum = g if grads_sum is None else [
            a + b for a, b in zip(grads_sum, g)]
    grads = tree_unflatten(c.params_like,
                           [g / len(grad_chunk_lists) for g in grads_sum])
    new_p, new_o, _ = opt_update(c.spec, grads, opt_state, params,
                                 clip_groups=clip_groups(c.cfg, params))
    return tree_leaves(new_p) + tree_leaves(new_o)


def take_params(full_chunks):
    return [np.asarray(a) for a in full_chunks[:_ctx().n_p]]


def take_opt(full_chunks):
    return [np.asarray(a) for a in full_chunks[_ctx().n_p:]]


def data(chunks):
    return [np.asarray(a) for a in chunks]


FNS = {"grad": grad, "opt": opt, "take_params": take_params,
       "take_opt": take_opt, "data": data}
