"""Flash attention forward: the hand-written Hopper kernel beside its plain
PyTorch version, and the autograd Function the training path runs;
:mod:`..runtime` resolves which forward a call runs."""
from . import kernel, ops, ref
from .kernel import flash_attention_kernel
from .ops import FlashAttentionFn, flash_attention, flash_attention_backward
from .ref import flash_attention_plain

__all__ = ["kernel", "ops", "ref", "flash_attention_kernel",
           "FlashAttentionFn", "flash_attention", "flash_attention_backward",
           "flash_attention_plain"]
