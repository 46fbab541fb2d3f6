"""Quickstart on the PyTorch port: the paper's own example (§2.2) — find
the maximum of an array with chunked jobs — through ``repro_torch.core``,
including the paper's plain-text job-file format (§3.3).  The port of
``examples/quickstart.py``; its workers sit on the card unless told
otherwise.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (ChunkedData, FunctionRegistry, LocalExecutor,
                              VirtualCluster, parse_job_text)

ap = argparse.ArgumentParser()
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                help="where the workers (and the chunks they compute "
                     "with) live: the card (default) or the CPU")
args = ap.parse_args()

# 1. register user functions (paper §3.2 — 'fat workers' hold all functions)
reg = FunctionRegistry()


@reg.chunkwise(1)                      # fn id 1: runs once per data chunk
def search_max(chunk):
    return torch.max(chunk)


@reg.whole(2)                          # fn id 2: sees all chunks assembled
def combine_max(*inputs):
    vals = [a for cd in inputs for a in cd.arrays()]
    return ChunkedData.from_arrays([torch.max(torch.stack(vals))])


# 2. describe the algorithm — two parallel jobs, then a combiner.  This is
#    the paper's job-file syntax: fn id, n_threads (0 = all cores), inputs.
graph = parse_job_text("""
  J1(1,0,0), J2(1,0,0);          # segment 1: search chunks in parallel
  J3(2,1,R1 R2);                 # segment 2: combine both results
""")

# 3. bind the input data as chunks (paper: "input data ... in amount of chunks")
A = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
graph.bind_input("J1", A[:600], n_chunks=6)
graph.bind_input("J2", A[600:], n_chunks=4)

# 4. run — the framework handles placement, transfers and synchronisation
devices = None if args.device == "cuda" else [torch.device("cpu")]
cluster = VirtualCluster(devices, n_schedulers=2, cores_per_worker=4,
                         max_workers=4)
results, report = LocalExecutor(cluster, reg).run(graph)

print("maximum found:", float(results["J3"].to_array()))
print("numpy says:   ", float(A.max()))
print("execution:    ", report.summary())
print("hybrid class: ", graph.is_hybrid()[1])
