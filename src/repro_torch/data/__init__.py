from .pipeline import (DataConfig, Prefetcher, SyntheticLMStream,
                       make_batch_specs, to_device)

__all__ = ["DataConfig", "Prefetcher", "SyntheticLMStream",
           "make_batch_specs", "to_device"]
