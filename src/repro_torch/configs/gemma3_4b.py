"""gemma3-4b [dense]: 5:1 local:global attention, 128k context, 262k vocab.
[hf:google/gemma-3-1b-pt; unverified]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10_240,
    vocab_size=262_144, head_dim=256,
    local_global_ratio=5, local_window=1024,
    embed_scale=True, qk_norm=True, rope_theta=1_000_000.0,
    tie_embeddings=True, act="gelu", max_seq=524_288,
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma3-4b-smoke", n_layers=6, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
    local_global_ratio=2, local_window=16, max_seq=256)

# sub-quadratic (5/6 of layers local-1024): long_500k runs
CELLS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
