"""Serving examples on the PyTorch port, on a reduced config of an
assigned architecture; the port of ``examples/serve_lm.py``, on the card
unless ``--device cpu`` is given.

Wave mode (batched prefill + decode, continuous batching demo)::

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch mamba2-370m]

Request-trace mode (Poisson arrivals, mixed prompt lengths, HyPar
dynamic-job scheduling)::

    PYTHONPATH=src python examples/torch_serve_lm.py --trace --engine hypar
"""
import sys

from repro_torch.launch.serve import main

args = ["--arch", "qwen2-1.5b", "--smoke", "--batch", "4",
        "--prompt-len", "16", "--max-new", "16", "--requests", "2"]
extra = sys.argv[1:]
if "--trace" in extra:
    args = ["--arch", "qwen2-1.5b", "--smoke", "--batch", "4",
            "--max-new", "12", "--n-requests", "8",
            "--prompt-lens", "6", "10", "14"]
main(args + extra)
