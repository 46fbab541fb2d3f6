"""mamba2-370m [ssm]: attention-free, SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=50_280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    tie_embeddings=True, use_rope=False, max_seq=524_288,
)

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-370m-smoke", n_layers=3, d_model=64,
    vocab_size=512, ssm_state=16, ssm_head_dim=16, ssm_chunk=16, max_seq=256)

CELLS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")  # SSM: runs long
