"""Training: the fused step (the tailored implementation) and the HyPar
job-graph trainer (the paper's framework)."""
from .hypar_loop import HyParTrainer
from .step import (TrainState, compute_grads, compute_grads_mesh, make_init_fn,
                   make_train_step, shard_state)

__all__ = ["HyParTrainer", "TrainState", "compute_grads", "compute_grads_mesh",
           "make_init_fn", "make_train_step", "shard_state"]
