"""qwen2-1.5b [dense]: GQA kv=2, QKV bias.  [arXiv:2407.10671; hf]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab_size=151_936, qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=True, max_seq=131_072,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2-1.5b-smoke", n_layers=3, d_model=96, n_heads=4,
    n_kv_heads=2, d_ff=192, vocab_size=512, max_seq=256)

CELLS = ("train_4k", "prefill_32k", "decode_32k")  # pure full attention: no long_500k
