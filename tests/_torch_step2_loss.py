"""Is llama3-405b's rise of the loss at step 2 under ``chip_smoke.py``'s
``train_llama3`` recipe the recipe's or the port's?

The recipe: llama3-405b's own settings (bf16 parameters and compute,
Adafactor, ``remat="full"``) at ``TRAIN_LR`` 3e-4 with no warm-up, a
global batch of 2 in 2 micro-batches, one layer.  This script runs that
recipe in both packages on the CPU at a width the CPU holds (one layer
of d_model 2,048 by default: 16 heads of 128, KV 8, ``d_ff`` 6,656, the
published vocabulary of 128,256), from the reference's initial state
(carried into the port by ``weights.train_state_from_jax_numpy``) on the
reference's synthetic batches, and prints each package's losses and the
ratio of each step's loss to step 1's.  Equal ratios put the rise on the
recipe; a gap between them is the port's.

    PYTHONPATH=src python tests/_torch_step2_loss.py [--d-model 2048]
        [--seq 128] [--steps 3] [--lr 3e-4]

It is a script, not a test (one run takes minutes on the CPU): pytest
collects no file whose name does not start with ``test_``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLMStream as JaxStream
from repro.optim import OptimizerSpec as JaxSpec
from repro.train import TrainState as JaxTrainState
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.data import to_device
from repro_torch.optim import OptimizerSpec
from repro_torch.train import make_train_step
from repro_torch.weights import train_state_from_jax_numpy

ARCH = "llama3-405b"
ACCUM = 2
BATCH = 2


def _cut(cfg, d_model: int):
    """One layer at ``d_model``, the published head width (128), KV heads
    and ``d_ff`` ratio kept; everything else the config's own."""
    hd = cfg.d_model // cfg.n_heads
    return dataclasses.replace(
        cfg, n_layers=1, d_model=d_model, n_heads=d_model // hd,
        d_ff=cfg.d_ff * d_model // cfg.d_model)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=2048)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--lr", type=float, default=3e-4)
    args = ap.parse_args(argv)

    jcfg = _cut(jax_get_config(ARCH), args.d_model)
    tcfg = _cut(get_config(ARCH), args.d_model)
    assert (jcfg.param_dtype, jcfg.compute_dtype, jcfg.optimizer) == \
        (tcfg.param_dtype, tcfg.compute_dtype, tcfg.optimizer) == \
        ("bfloat16", "bfloat16", "adafactor")
    stream = JaxStream(jcfg, JaxDataConfig(seed=0, global_batch=BATCH,
                                           seq_len=args.seq))
    batches = [stream.batch(i) for i in range(args.steps)]

    t0 = time.perf_counter()
    jspec = JaxSpec(kind=jcfg.optimizer, lr=args.lr)
    state = JaxTrainState.create(jcfg, jspec, jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, {"params": state.params,
                                     "opt_state": state.opt_state,
                                     "step": state.step})
    step = jax.jit(jax_make_train_step(jcfg, jspec, grad_accum=ACCUM))
    ref = []
    for b in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        ref.append(float(m["loss_total"]))
    t_ref = time.perf_counter() - t0
    del state, step

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    tstate = train_state_from_jax_numpy(init, tcfg, cpu)
    del init
    tstep = make_train_step(tcfg, OptimizerSpec(kind=tcfg.optimizer,
                                                lr=args.lr),
                            grad_accum=ACCUM)
    port = []
    for b in batches:
        tstate, m = tstep(tstate, to_device(b, cpu))
        port.append(float(m["loss_total"]))
    t_port = time.perf_counter() - t0

    out = {"arch": ARCH, "layers": 1, "d_model": jcfg.d_model,
           "n_heads": jcfg.n_heads, "n_kv_heads": jcfg.n_kv_heads,
           "d_ff": jcfg.d_ff, "vocab": jcfg.vocab_size, "seq": args.seq,
           "global_batch": BATCH, "grad_accum": ACCUM, "lr": args.lr,
           "reference_loss": ref, "port_loss": port,
           "reference_ratio": [x / ref[0] for x in ref],
           "port_ratio": [x / port[0] for x in port],
           "reference_s": t_ref, "port_s": t_port}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
