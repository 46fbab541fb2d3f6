"""End-to-end training driver on the PyTorch port: a ~100M-parameter
qwen2-family model for a few hundred steps on synthetic data, with
checkpointing; the port of ``examples/train_lm.py``, on the card unless
``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/torch_train_lm.py  (add --steps 300
for the full run; ``--smoke --device cpu --steps 2 --ckpt-dir DIR`` runs
the smoke config on the CPU)
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main

args = ["--arch", "qwen2-1.5b", "--layers", "8", "--d-model", "768",
        "--steps", "60", "--batch", "8", "--seq", "256",
        "--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                   "repro_torch_train_lm"),
        "--ckpt-every", "50",
        "--log-every", "10"]
main(args + sys.argv[1:])
