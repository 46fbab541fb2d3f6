"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed experts top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=151_936, n_experts=60, top_k=4, moe_d_ff=1408,
    n_shared_experts=4, qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=False, max_seq=131_072,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2-moe-a2.7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=96, vocab_size=512, n_experts=8, top_k=2,
    moe_d_ff=96, n_shared_experts=2, max_seq=256)

CELLS = ("train_4k", "prefill_32k", "decode_32k")
