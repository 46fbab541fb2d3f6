"""The paper's §4 experiment on the PyTorch port: a Jacobi solver
parallelised through the framework vs the tailored implementation, at
demo scale.  The port of ``examples/jacobi_hybrid.py``; the system lives
on the card unless told otherwise.

Run:  PYTHONPATH=src python examples/torch_jacobi_hybrid.py [n] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.apps.jacobi import (jacobi_hypar, jacobi_spmd,
                                     jacobi_tailored, make_system)

ap = argparse.ArgumentParser()
ap.add_argument("n", type=int, nargs="?", default=1024)
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                help="where the system lives: the card (default) or the CPU")
args = ap.parse_args()

n = args.n
A, b, x_true = make_system(n, device=args.device)
print(f"solving {n}x{n} diagonally-dominant system, 200 iterations\n")

for name, fn in [("tailored (fused while_loop)", jacobi_tailored),
                 ("HyPar job graph (paper)", jacobi_hypar),
                 ("HyPar SPMD-fused (beyond paper)", jacobi_spmd)]:
    r = fn(A, b, iters=200, tol=1e-5)
    err = np.max(np.abs(np.asarray(r.x) - x_true))
    print(f"{name:34s} iters={r.iters:3d} residual={r.residual:.2e} "
          f"err={err:.2e} time={r.seconds*1e3:8.1f}ms")
