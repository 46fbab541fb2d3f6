"""chameleon-34b [vlm]: early-fusion, VQ image tokens in the text vocab;
the VQ tokenizer frontend is a STUB — inputs are token ids.  qk-norm for
stability as in the paper.  [arXiv:2405.09818; unverified]"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22_016,
    vocab_size=65_536, qk_norm=True, tie_embeddings=False,
    max_seq=131_072,
)

SMOKE = dataclasses.replace(
    CONFIG, name="chameleon-34b-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, max_seq=256)

CELLS = ("train_4k", "prefill_32k", "decode_32k")
