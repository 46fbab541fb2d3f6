"""Training: the fused step (the tailored implementation) and the HyPar
job-graph trainer (the paper's framework)."""
from .hypar_loop import HyParTrainer
from .step import TrainState, compute_grads, make_init_fn, make_train_step

__all__ = ["HyParTrainer", "TrainState", "compute_grads", "make_init_fn",
           "make_train_step"]
