"""Standalone master process for the port's crash-soak test
(``tests/test_torch_proc_crash_soak.py``).

Runs one ``repro_torch`` ProcessExecutor pass of the
``repro_torch.apps.procdemo`` graph against a durable store, its cluster on
the CPU.  Must be a real file (not ``python -c``/stdin): spawn children
re-resolve ``__main__`` from its path, so an inline script would crash
every worker at boot.  The soak test launches this under
``REPRO_PROCDEMO_SLEEP`` and SIGKILLs it mid-run.  Imports only
``repro_torch``.

    python tests/_torch_soak_driver.py STORE WIDTH DEPTH DIM SEED
"""
import sys


def main() -> None:
    store = sys.argv[1]
    width, depth, dim, seed = (int(a) for a in sys.argv[2:6])
    import torch

    from repro_torch.apps import procdemo
    from repro_torch.core import ProcessExecutor, VirtualCluster

    ex = ProcessExecutor(VirtualCluster([torch.device("cpu")],
                                        n_schedulers=1, max_workers=2),
                         procdemo.make_registry(), procdemo.WORKER_FNS_SPEC,
                         store=store, heartbeat_interval_s=0.1,
                         heartbeat_max_missed=3)
    try:
        ex.run(procdemo.build_graph(width=width, depth=depth, dim=dim,
                                    seed=seed))
        print("DONE", ex.n_executed, ex.n_memoised, flush=True)
    finally:
        ex.close()


if __name__ == "__main__":
    main()
