"""zamba2-1.2b [hybrid]: Mamba2 backbone + one SHARED attention block
invoked every 6 SSM blocks.  [arXiv:2411.15242; hf]

Simplification noted in DESIGN.md: the shared block is one parameter set
re-invoked (Zamba2's per-invocation LoRA deltas are omitted).
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32_000, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    hybrid_attn_every=6, tie_embeddings=True, max_seq=524_288,
)

SMOKE = dataclasses.replace(
    CONFIG, name="zamba2-1.2b-smoke", n_layers=5, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=512, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=16, hybrid_attn_every=2, max_seq=256)

CELLS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")  # hybrid: runs long
