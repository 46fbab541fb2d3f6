from .optimizers import (OptimizerSpec, clip_by_global_norm, cosine_schedule,
                         global_norm, init_opt_state, opt_update,
                         opt_update_placed)

__all__ = ["OptimizerSpec", "clip_by_global_norm", "cosine_schedule",
           "global_norm", "init_opt_state", "opt_update",
           "opt_update_placed"]
