"""Basic layers: norms, MLPs, embeddings, RoPE — plain functions on
tensors over dict params, in the JAX package's layouts (dense weights are
(d_in, d_out) and used as ``x @ w``).

Parameter casts: ``dense``, ``embed`` and ``unembed`` cast weights to the
compute dtype on every call, as the reference does.  A serving engine casts
its weights once up front (:func:`cast_weights`), after which these casts
are no-ops; the values are identical either way.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..analysis import opcount
from ..dtypes import DTYPES, dtype_of
from ..parallel.partition import model_axis_dim, view_region
from .config import ModelConfig

__all__ = [
    "DTYPES", "dtype_of", "init_norm", "apply_norm", "init_mlp", "apply_mlp",
    "split_mlp", "apply_mlp_tp",
    "init_embedding", "embed", "unembed", "vocab_split", "split_vocab",
    "embed_tp", "unembed_tp", "rope_freqs", "apply_rope",
    "init_dense", "dense", "truncated_normal", "cast_weights",
]


def truncated_normal(generator: torch.Generator, shape, scale: float,
                     dtype: torch.dtype, device) -> torch.Tensor:
    """Truncated-normal init on [-2, 2] standard deviations, rescaled so the
    result has standard deviation ``scale`` (the reference's convention).
    Drawn in fp32 from ``generator`` (which must live on ``device``)."""
    stddev = scale / 0.87962566103423978
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return (t * stddev).to(dtype)


# -- norms ---------------------------------------------------------------------


def init_norm(cfg: ModelConfig, device, shape_d: int | None = None) -> dict:
    d = shape_d or cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    p = {"scale": torch.ones((d,), dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dt, device=device)
    return p


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
               eps: float = 1e-6, use_kernel: bool = False) -> torch.Tensor:
    """RMSNorm / LayerNorm with fp32 accumulation, output in x.dtype.

    ``use_kernel`` sends RMSNorm through the kernel wrapper
    (:func:`repro_torch.kernels.rmsnorm.rmsnorm`: the hand-written kernel
    on a CUDA tensor, its plain version on a CPU one), as the reference's
    switch does.  The kernel is forward only; no caller sets the switch."""
    if use_kernel and cfg.norm == "rmsnorm":
        from repro_torch.kernels.rmsnorm import ops as rms_ops
        return rms_ops.rmsnorm(x, p["scale"].float(), eps=eps)
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].float() \
            + p["bias"].float()
    return out.to(x.dtype)


# -- dense / MLP -----------------------------------------------------------------


def init_dense(generator, d_in: int, d_out: int, cfg: ModelConfig, device, *,
               bias: bool = False, scale: float | None = None) -> dict:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    dt = dtype_of(cfg.param_dtype)
    p = {"w": truncated_normal(generator, (d_in, d_out), scale, dt, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dt, device=device)
    return p


def dense(p: dict, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    out = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        out = out + p["b"].to(compute_dtype)
    return out


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name}")


def init_mlp(generator, cfg: ModelConfig, device, d_ff: int | None = None, *,
             gated: bool | None = None) -> dict:
    """Gated (SwiGLU-style) or plain 2-layer MLP."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    gated = gated if gated is not None else (cfg.act == "silu")
    p = {"up": init_dense(generator, d, ff, cfg, device),
         "down": init_dense(generator, ff, d, cfg, device,
                            scale=1.0 / math.sqrt(ff))}
    if gated:
        p["gate"] = init_dense(generator, d, ff, cfg, device)
    return p


def apply_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    cd = dtype_of(cfg.compute_dtype)
    up = dense(p["up"], x, cd)
    if "gate" in p:
        h = _act(cfg.act, dense(p["gate"], x, cd)) * up
    else:
        h = _act(cfg.act, up)
    return dense(p["down"], h, cd)


def split_mlp(p: dict, n: int, i: int, *, take=view_region) -> dict:
    """Shard ``i`` of ``n`` of an MLP, split by ``d_ff``: the i-th block of
    the ``up`` and ``gate`` columns (weights and biases) and of the
    ``down`` rows.  ``down``'s bias goes to shard 0 alone, so
    :func:`apply_mlp_tp`'s sum adds it once.  The blocks are views of
    ``p`` (``take``, as for ``attention.split_attention``, reads each
    region); one shard of one is ``p`` itself."""
    if n == 1:
        return p
    ff = p["up"]["w"].shape[1]
    if ff % n or not 0 <= i < n:
        raise ValueError(f"shard {i} of {n} does not split d_ff {ff}")
    cut = slice(i * ff // n, (i + 1) * ff // n)

    def cols(d: dict) -> dict:
        out = {"w": take(d["w"], (slice(None), cut))}
        if "b" in d:
            out["b"] = take(d["b"], (cut,))
        return out

    out = {"up": cols(p["up"]), "down": {"w": take(p["down"]["w"], (cut,))}}
    if "gate" in p:
        out["gate"] = cols(p["gate"])
    if i == 0 and "b" in p["down"]:
        out["down"]["b"] = take(p["down"]["b"], ())
    return out


def apply_mlp_tp(cfg: ModelConfig, shards, x: torch.Tensor) -> torch.Tensor:
    """An MLP over tensor-parallel shards: ``shards`` holds ``(params,
    device)`` of each shard (:func:`split_mlp`), in shard order.  Each
    shard runs on its device (x moved there), and the partial outputs are
    summed in shard order on x's device."""
    out = None
    for p_s, dev in opcount.each_position(shards):
        part = apply_mlp(cfg, p_s,
                         opcount.shard_input(x, "mlp_tp_grad").to(dev))
        if len(shards) > 1:
            opcount.collective("all-reduce", part, site="mlp_tp")
        part = part.to(x.device)
        out = part if out is None else out + part
    return out


# -- embeddings -------------------------------------------------------------------


def init_embedding(generator, cfg: ModelConfig, device) -> dict:
    """(padded_vocab, d) table; the padded rows are random too, as in the
    reference (greedy argmax runs over them, so they are never masked)."""
    V, d = cfg.padded_vocab, cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    p = {"table": truncated_normal(generator, (V, d), 1.0, dt, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = truncated_normal(generator, (V, d),
                                        1.0 / math.sqrt(d), dt, device)
    return p


class _RowsSumF32(torch.autograd.Function):
    """``table[idx].to(cd)`` whose gradient is scatter-added in fp32 and
    cast to the table's dtype once (a bf16 table's)."""

    @staticmethod
    def forward(ctx, table, idx, cd):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table[idx].to(cd)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        acc = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        acc.index_add_(0, idx.reshape(-1), g.reshape(-1, g.shape[-1]).float())
        return acc.to(ctx.dtype), None, None


def _take_rows(table: torch.Tensor, idx: torch.Tensor,
               cd: torch.dtype) -> torch.Tensor:
    """Rows ``idx`` of ``table`` in the compute dtype ``cd``, their
    gradient summed in fp32 whatever the table's dtype: an fp32 table's
    in its own dtype, a bf16 table's (bf16 parameters) through
    :class:`_RowsSumF32`."""
    if table.dtype == torch.float32 or not (torch.is_grad_enabled()
                                            and table.requires_grad):
        return table[idx].to(cd)
    return _RowsSumF32.apply(table, idx, cd)


def embed(cfg: ModelConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' rows of the table in the compute dtype.  The rows are
    gathered and then cast (the reference casts the whole table and then
    gathers: the same values), and the gradient's scatter-add over
    repeated tokens runs in fp32 (:func:`_take_rows`) and not in bf16,
    where a frequent token's thousands of rows lose most of their sum to
    rounding, and differently for each split of the batch; a bf16 table's
    gradient is that sum rounded once, as the reference's is at fp32
    compute."""
    cd = dtype_of(cfg.compute_dtype)
    x = _take_rows(p["table"], tokens.long(), cd)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cd)
    return x


def unembed(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    cd = dtype_of(cfg.compute_dtype)
    table = p.get("unembed", p["table"])
    return x.to(cd) @ table.to(cd).T


def vocab_split(p: dict, n: int) -> bool:
    """Whether ``n`` tensor-parallel positions split the embedding (``p``)
    by ``vocab``: where the table's spec puts ``model`` on its rows (an
    untied ``unembed`` has the table's shape and spec)."""
    return "table" in p and model_axis_dim(("embed", "table"),
                                           p["table"].shape, n) == 0


def split_vocab(p: dict, n: int, i: int, *,
                take=view_region) -> tuple[dict, int]:
    """Shard ``i`` of ``n`` of the embedding, split by ``vocab``: rows
    ``[lo, hi)`` (``lo = i·V/n``) of the table, and of ``unembed`` where
    the tables are not tied, as views (``take`` reads each region, as for
    ``attention.split_attention``).  Returns ``(rows, lo)``."""
    V = p["table"].shape[0]
    if V % n or not 0 <= i < n:
        raise ValueError(f"shard {i} of {n} does not split a vocabulary "
                         f"of {V}")
    lo, hi = i * V // n, (i + 1) * V // n
    return {k: take(t, (slice(lo, hi),)) for k, t in p.items()}, lo


def embed_tp(cfg: ModelConfig, shards, tokens: torch.Tensor) -> torch.Tensor:
    """:func:`embed` over vocab shards (``[(rows, lo, device), ...]`` in
    shard order, :func:`split_vocab`): each shard gathers the tokens in
    its row range and zero elsewhere, in the table's dtype, then casts;
    the parts are summed in shard order on ``tokens``' device (exact:
    one term of a token is nonzero), and ``embed_scale`` is applied after
    the sum.  The gradient of each shard's rows accumulates in fp32, as
    :func:`embed`'s does."""
    cd = dtype_of(cfg.compute_dtype)
    x = None
    for rows, lo, dev in opcount.each_position(shards):
        t = tokens.to(dev).long() - lo
        table = rows["table"]
        inside = ((t >= 0) & (t < table.shape[0]))[..., None]
        part = torch.where(inside, _take_rows(
            table, t.clamp(0, table.shape[0] - 1), cd),
            torch.zeros((), dtype=cd, device=dev))
        opcount.collective("all-reduce", part, site="embed_tp")
        part = part.to(tokens.device)
        x = part if x is None else x + part
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cd)
    return x


def unembed_tp(cfg: ModelConfig, shards, x: torch.Tensor) -> list:
    """:func:`unembed` over vocab shards: each shard's logits (..., V/n)
    over its rows, on its device, in shard order."""
    cd = dtype_of(cfg.compute_dtype)
    return [opcount.shard_input(x, "unembed_tp_grad").to(dev).to(cd)
            @ rows.get("unembed", rows["table"]).to(cd).T
            for rows, _, dev in opcount.each_position(shards)]


def cast_weights(params, compute_dtype: torch.dtype):
    """Copy of ``params`` with every dense weight/bias (``w``/``b``),
    embedding table and MoE expert tensor (``gate``/``up``/``down`` arrays)
    cast to ``compute_dtype`` once — the casts ``dense``, ``embed``,
    ``unembed`` and the expert products would otherwise repeat on every
    call.  Norm scales keep their dtype (``apply_norm`` reads them in
    fp32), and so do the MoE router and shared-expert gate, which the
    reference reads in fp32."""
    if isinstance(params, dict):
        return {k: (v if k in _KEEP_DTYPE
                    else v.to(compute_dtype) if k in _CAST
                    and isinstance(v, torch.Tensor)
                    else cast_weights(v, compute_dtype))
                for k, v in params.items()}
    if isinstance(params, list):
        return [cast_weights(v, compute_dtype) for v in params]
    return params


_CAST = ("w", "b", "table", "unembed", "gate", "up", "down")
_KEEP_DTYPE = ("router", "shared_gate")


# -- RoPE -------------------------------------------------------------------------


def rope_freqs(cfg: ModelConfig, positions: torch.Tensor,
               hd: int | None = None, theta: float | None = None):
    """Returns (sin, cos) of shape positions.shape + (hd/2,), fp32."""
    hd = hd or cfg.hd
    theta = theta or cfg.rope_theta
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, hd); sin/cos: (..., seq, hd/2) broadcast over
    heads."""
    x1, x2 = x.float().chunk(2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
