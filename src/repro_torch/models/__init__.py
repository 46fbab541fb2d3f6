"""Model code of the port: configuration, layers, attention, the Mamba-2
mixer, the mixture-of-experts block, and the serving steps over the dense
and the paged cache."""
from .transformer import (chunk_prefill_step, decode_step, init_cache,
                          init_paged_cache, param_count, prefill)

__all__ = ["init_cache", "init_paged_cache", "decode_step", "prefill",
           "chunk_prefill_step", "param_count"]
