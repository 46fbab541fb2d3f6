"""Flash attention: the hand-written Hopper kernels (forward and backward)
beside their plain PyTorch versions, and the autograd Function the
training path runs; :mod:`..runtime` resolves which pair a call runs."""
from . import kernel, ops, ref
from .kernel import (cost, flash_attention_backward_kernel,
                     flash_attention_kernel)
from .ops import FlashAttentionFn, flash_attention
from .ref import flash_attention_backward_plain, flash_attention_plain

__all__ = ["kernel", "ops", "ref", "cost", "flash_attention_kernel",
           "flash_attention_backward_kernel", "FlashAttentionFn",
           "flash_attention", "flash_attention_backward_plain",
           "flash_attention_plain"]
