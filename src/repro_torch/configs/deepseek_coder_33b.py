"""deepseek-coder-33b [dense]: llama-arch GQA kv=8.  [arXiv:2401.14196; hf]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19_200,
    vocab_size=32_256, rope_theta=100_000.0, tie_embeddings=False,
    max_seq=131_072,
)

SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-coder-33b-smoke", n_layers=3, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=160, vocab_size=512, max_seq=256)

CELLS = ("train_4k", "prefill_32k", "decode_32k")
