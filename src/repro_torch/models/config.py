"""Model configuration — one dataclass covers every assigned architecture.

Families: dense | moe | ssm | hybrid | encdec | vlm (vlm/audio reuse the
transformer backbone with a stub modality frontend, per the assignment).
"""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "ShapeCell", "SHAPE_CELLS", "round_up"]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0             # 0 -> d_model // n_heads
    # --- attention ---
    rope_theta: float = 10_000.0
    use_rope: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False                 # chameleon stability trick
    sliding_window: int | None = None     # mixtral SWA
    local_global_ratio: int = 0           # gemma3: 5 local per 1 global
    local_window: int | None = None       # gemma3 local attention window
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                     # routed expert hidden width
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (zamba2): one shared attention block every k SSM blocks ---
    hybrid_attn_every: int = 0
    # --- encoder-decoder (whisper) ---
    n_encoder_layers: int = 0
    decoder_len: int = 448                # whisper max target positions
    # --- misc arch ---
    act: str = "silu"                     # silu | gelu
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    tie_embeddings: bool = True
    embed_scale: bool = False             # gemma: embeddings * sqrt(d_model)
    max_seq: int = 131_072
    # --- numerics / training ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = ""              # "" -> compute_dtype; f8 for big serving
    optimizer: str = "adamw"              # adamw | adafactor
    remat: str = "full"                   # none | full | save_dots
    scan_layers: bool = True
    # --- parallelism hints (see parallel/sharding.py) ---
    vocab_pad_multiple: int = 256
    attn_partitioning: str = "auto"       # auto | heads | context
    activation_seq_shard: bool = True     # False: Megatron-style replicated
                                          # activations between blocks (H2)
    grad_accum: int = 1

    # ---- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Total parameter count (embedding included once when tied)."""
        d, ff, V = self.d_model, self.d_ff, self.padded_vocab
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        attn = d * hd * H + 2 * d * hd * KV + hd * H * d       # q,k,v,o
        if self.qkv_bias:
            attn += hd * (H + 2 * KV)
        mlp_dense = 3 * d * ff                                  # gate,up,down
        per_layer = 0
        if self.family == "ssm":
            di, s = self.ssm_d_inner, self.ssm_state
            ng = max(1, self.ssm_n_heads // 8)  # group count heuristic unused
            # in_proj: d -> 2*di + 2*state + n_heads(dt); out_proj: di -> d
            per_layer = d * (2 * di + 2 * s + self.ssm_n_heads) + di * d \
                + self.ssm_conv * (di + 2 * s) + 2 * d
            total = self.n_layers * per_layer
        elif self.family == "hybrid":
            di, s = self.ssm_d_inner, self.ssm_state
            m_layer = d * (2 * di + 2 * s + self.ssm_n_heads) + di * d \
                + self.ssm_conv * (di + 2 * s) + 2 * d
            total = self.n_layers * m_layer + (attn + mlp_dense + 2 * d)
        elif self.is_moe:
            routed = 3 * d * self.moe_d_ff * self.n_experts if self.moe_d_ff \
                else 3 * d * self.d_ff * self.n_experts
            shared = 3 * d * (self.moe_d_ff * self.n_shared_experts) \
                if self.n_shared_experts else 0
            router = d * self.n_experts
            per_layer = attn + routed + shared + router + 2 * d
            total = self.n_layers * per_layer
        else:
            per_layer = attn + mlp_dense + 2 * d
            total = self.n_layers * per_layer
            if self.family == "encdec":
                # encoder layers + decoder cross-attention
                total += self.n_encoder_layers * (attn + mlp_dense + 2 * d)
                total += self.n_layers * (attn + d)
        total += V * d                                  # embedding
        if not self.tie_embeddings:
            total += V * d
        total += d                                      # final norm
        return int(total)

    def active_params(self) -> int:
        """Parameters touched per token (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        ew = self.moe_d_ff or self.d_ff
        dead = 3 * d * ew * (self.n_experts - self.top_k) * self.n_layers
        return self.n_params() - int(dead)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}
