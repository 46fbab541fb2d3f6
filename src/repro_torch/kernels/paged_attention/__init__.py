from . import kernel, ops, ref
from .kernel import cost, paged_attention_kernel, paged_decode_kernel
from .ops import paged_decode_attention
from .ref import (gather_pages_ref, merge_splits_plain,
                  paged_attention_plain, paged_attention_split_plain,
                  paged_decode_attention_ref)

__all__ = ["kernel", "ops", "ref", "cost", "paged_attention_kernel",
           "paged_decode_kernel", "paged_decode_attention",
           "gather_pages_ref", "merge_splits_plain", "paged_attention_plain",
           "paged_attention_split_plain", "paged_decode_attention_ref"]
