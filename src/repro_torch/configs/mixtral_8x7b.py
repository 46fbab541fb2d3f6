"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14_336,
    vocab_size=32_000, n_experts=8, top_k=2, moe_d_ff=14_336,
    sliding_window=4096, rope_theta=1_000_000.0, tie_embeddings=False,
    max_seq=524_288,
)

SMOKE = dataclasses.replace(
    CONFIG, name="mixtral-8x7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, n_experts=4, top_k=2,
    moe_d_ff=96, sliding_window=16, max_seq=256)

# SWA => sub-quadratic: long_500k runs
CELLS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
