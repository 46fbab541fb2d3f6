"""whisper-base [audio]: enc-dec, conv frontend STUB (input_specs provides
precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_encoder_layers=6,
    d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=51865,
    use_rope=False, norm="layernorm", act="gelu",
    tie_embeddings=True, decoder_len=448, max_seq=32_768 + 8,
    rope_theta=10_000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="whisper-base-smoke", n_layers=2, n_encoder_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
    max_seq=256, decoder_len=32)

# long_500k skipped: decoder context architecturally capped (DESIGN.md §4)
CELLS = ("train_4k", "prefill_32k", "decode_32k")
