"""llama3-405b [dense]: GQA kv=8, 128k vocab.  [arXiv:2407.21783; unverified]

Memory note (DESIGN.md §4): at 405B params AdamW fp32 states (12 B/param)
exceed 256×16 GB; production config uses Adafactor (factored second moment)
with fp32 params — the T5X-style recipe — plus full per-layer remat.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16_384, n_heads=128, n_kv_heads=8, d_ff=53_248,
    vocab_size=128_256, rope_theta=500_000.0, tie_embeddings=False,
    optimizer="adafactor", remat="full", max_seq=131_072,
    # bf16 params + Adafactor: params 3.2 GiB/chip, bf16 micro-grads with an
    # fp32 accumulator -- the combination that fits 405B training on a
    # 256-chip v5e pod (16 GiB HBM); see EXPERIMENTS.md §Dry-run.
    param_dtype="bfloat16",
    # f8 KV cache: 405B decode at 32k x 128 slots on one 16 GiB/chip pod
    # needs 4.2 GiB/chip of cache instead of 8.4 (direct-cast e4m3; per-head
    # scaling is a noted TODO)
    kv_cache_dtype="float8_e4m3fn",
    activation_seq_shard=False,   # H2 (EXPERIMENTS.md §Perf): -seq<->heads reshard storm
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama3-405b-smoke", n_layers=3, d_model=128, n_heads=8,
    n_kv_heads=2, d_ff=256, vocab_size=512, optimizer="adamw", max_seq=256,
    kv_cache_dtype="")  # smoke tests check exact decode parity; f8 is a serving choice

CELLS = ("train_4k", "prefill_32k", "decode_32k")
