"""``chip_smoke.py``'s step-1 gate of its training runs, held against
wrong backwards on the card.

    python3 src/repro_torch/benchmarks/grad_gate.py

For each model of ``chip_smoke.TRAIN_RUNS`` (same config, depth cut,
batch and seed), step 1's loss and gradients by the kernel path and the
plain path (``chip_smoke.step1_gaps``, no update): first as shipped, then
with one output of a backward halved in every call: of the flash backward
(dq, dk or dv; for whisper only where S differs from T, the
cross-attention) or of the SSD intra-chunk backward (dx, dB, dC or da).
It prints the card's ``nvidia-smi`` line and one JSON line a run: the
loss and grad-norm gaps, the worst gradient leaves and whether
``chip_smoke.step1_ok`` passes the run.  It exits 1 without a CUDA device,
and 2 if a run as shipped fails the gate or a wrong backward passes it.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[3]

#: model -> (label, backward, output index, cross-attention only)
WRONG = {
    "qwen2-1.5b": [("flash dq x 0.5", "flash", 0, False)],
    "mamba2-370m": [("SSD dx x 0.5", "ssd", 0, False),
                    ("SSD dC x 0.5", "ssd", 4, False),
                    ("SSD da x 0.5", "ssd", 2, False)],
    "zamba2-1.2b": [("flash dk x 0.5", "flash", 1, False),
                    ("SSD dB x 0.5", "ssd", 3, False)],
    "whisper-base": [("cross-attention dv x 0.5", "flash", 2, True),
                     ("cross-attention dk x 0.5", "flash", 1, True)],
    "qwen2-moe-a2.7b": [("flash dv x 0.5", "flash", 2, False)],
    "gemma3-4b": [("flash dq x 0.5", "flash", 0, False),
                  ("flash dk x 0.5", "flash", 1, False)],
}


def _halve(grads, i: int) -> tuple:
    grads = list(grads)
    grads[i] = grads[i] * 0.5
    return tuple(grads)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("grad_gate: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(_ROOT / "src"), str(_ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan.ops import SsdIntraChunkFn
    from repro_torch.optim import OptimizerSpec
    from repro_torch.train import TrainState

    print(cs.nvidia_smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    flash_bwd = fa_ops.flash_attention_backward_kernel
    ssd_bwd = SsdIntraChunkFn.backward

    def wrong_flash(i, cross_only):
        def backward(q, k, v, *args, **kw):
            grads = flash_bwd(q, k, v, *args, **kw)
            cross = q.shape[1] != k.shape[1]
            return _halve(grads, i) if cross or not cross_only else grads
        return backward

    def wrong_ssd(i):
        return staticmethod(lambda ctx, dy, dS: _halve(ssd_bwd(ctx, dy, dS),
                                                       i))

    bad = 0
    for _, arch, depth, plain, _, _ in cs.TRAIN_RUNS:
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        batch = cs.train_batches(cfg, 1)[0]
        params = TrainState.create(
            cfg, OptimizerSpec(kind="adamw", lr=cs.TRAIN_LR),
            torch.Generator(device=cs.DEV).manual_seed(0), cs.DEV).params
        for label, where, i, cross_only in [("as shipped", None, 0, False),
                                            *WRONG.get(arch, [])]:
            if where == "flash":
                fa_ops.flash_attention_backward_kernel = wrong_flash(
                    i, cross_only)
            elif where == "ssd":
                SsdIntraChunkFn.backward = wrong_ssd(i)
            try:
                gaps = cs.step1_gaps(cfg, params, batch, plain)
            finally:
                fa_ops.flash_attention_backward_kernel = flash_bwd
                SsdIntraChunkFn.backward = staticmethod(ssd_bwd)
            loss_p = gaps["plain_path_step1_loss"]
            gnorm_p = gaps["plain_path_step1_grad_norm"]
            loss_err = abs(gaps["kernel_path_step1_loss"] - loss_p) / abs(
                loss_p)
            gnorm_err = abs(gaps["kernel_path_step1_grad_norm"]
                            - gnorm_p) / gnorm_p
            ok = cs.step1_ok(loss_err, gnorm_err, gaps)
            bad += ok != (where is None)
            print(json.dumps({"model": arch, "run": label,
                              "loss_rel_err": loss_err,
                              "grad_norm_rel_err": gnorm_err,
                              "passes_gate": ok, **gaps}), flush=True)
        del params, batch
        torch.cuda.empty_cache()
    return 2 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
