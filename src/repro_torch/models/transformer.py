"""Model composition for the serving path: the dense GQA decoder family.

Parameters are the JAX package's pytree unstacked: ``{"embed": {"table"},
"layers": [block, ...], "norm_f": {"scale"}}`` with one dict per layer
(the reference stacks layers on a leading axis for ``lax.scan``; here a
plain Python loop runs them).  The paged serving cache is
``{"k": (L, P, KV, ps, D), "v": (L, P, KV, ps, D), "len": (B,) int32}``:
one page pool per layer and per K/V, so ``cache["k"][i]`` is layer i's
contiguous pool.

Both steps UPDATE THE CACHE IN PLACE (pools and ``len``) and return the
same dict — the reference returns a new cache.  Every layer reads its pool
before writing its own K/V delta into it, and layers never share a pool,
so the result equals the reference's read-all-then-write order.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.runtime import resolve_impl
from .attention import attention, gather_pages, init_attention
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, dtype_of, embed, init_embedding,
                     init_mlp, init_norm, unembed)

__all__ = ["LayerPlan", "layer_plan", "init_block", "apply_block",
           "init_params", "init_paged_cache", "decode_step",
           "chunk_prefill_step", "check_supported"]


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    pattern: tuple[str, ...]
    n_groups: int
    tail: tuple[str, ...]
    enc_pattern: tuple[str, ...] = ()
    enc_groups: int = 0


def layer_plan(cfg: ModelConfig) -> LayerPlan:
    L = cfg.n_layers
    if cfg.family == "encdec":
        return LayerPlan(pattern=("dec",), n_groups=L, tail=(),
                         enc_pattern=("enc",), enc_groups=cfg.n_encoder_layers)
    if cfg.family == "ssm":
        return LayerPlan(pattern=("ssm",), n_groups=L, tail=())
    if cfg.family == "hybrid":
        k = cfg.hybrid_attn_every
        g, r = divmod(L, k)
        return LayerPlan(pattern=("ssm",) * k + ("shared",), n_groups=g,
                         tail=("ssm",) * r)
    if cfg.local_global_ratio:
        k = cfg.local_global_ratio + 1
        g, r = divmod(L, k)
        return LayerPlan(pattern=("local",) * cfg.local_global_ratio + ("global",),
                         n_groups=g, tail=("local",) * r)
    if cfg.is_moe:
        return LayerPlan(pattern=("moe",), n_groups=L, tail=())
    return LayerPlan(pattern=("dense",), n_groups=L, tail=())


def check_supported(cfg: ModelConfig) -> None:
    """The port runs the dense family (attention + gated MLP in every
    layer); the other block kinds come with later slices."""
    plan = layer_plan(cfg)
    if plan.pattern != ("dense",) or plan.tail:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {plan.pattern + plan.tail} are not "
            f"ported yet (the port runs the dense family only)")


# ---------------------------------------------------------------------------
# Blocks and parameters
# ---------------------------------------------------------------------------


def init_block(generator, cfg: ModelConfig, device) -> dict:
    return {"ln1": init_norm(cfg, device),
            "attn": init_attention(generator, cfg, device),
            "ln2": init_norm(cfg, device),
            "mlp": init_mlp(generator, cfg, device)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> dict:
    """Random parameters in the port's layout, with the reference's
    truncated-normal scales, drawn from ``generator`` (which must live on
    ``device``).  The numbers differ from the reference's JAX PRNG stream;
    parity tests carry JAX weights over with ``weights.from_jax_numpy``."""
    check_supported(cfg)
    return {"embed": init_embedding(generator, cfg, device),
            "layers": [init_block(generator, cfg, device)
                       for _ in range(cfg.n_layers)],
            "norm_f": init_norm(cfg, device)}


def apply_block(cfg: ModelConfig, p: dict, x: torch.Tensor, *, positions,
                cache: dict, cache_len, paged_impl: str = "auto"):
    """One dense block (attention + gated MLP, pre-norm, residuals).
    Returns ``(x, (kt, vt))`` with the block's K/V delta."""
    window = cfg.sliding_window
    h = apply_norm(cfg, p["ln1"], x)
    out, kv = attention(cfg, p["attn"], h, positions=positions, cache=cache,
                        cache_len=cache_len, window=window,
                        paged_impl=paged_impl)
    x = x + out
    h = apply_norm(cfg, p["ln2"], x)
    x = x + apply_mlp(cfg, p["mlp"], h)
    return x, kv


# ---------------------------------------------------------------------------
# Paged cache and steps
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: ModelConfig, batch: int, *, num_pages: int,
                     page_size: int, device) -> dict:
    """Paged serving cache: one shared page pool (P, KV, page_size, D) per
    layer and per K/V, stacked on a leading layer axis, plus per-slot
    lengths.  Page 0 is the trash page."""
    check_supported(cfg)
    dt = dtype_of(cfg.kv_cache_dtype or cfg.compute_dtype)
    shape = (cfg.n_layers, num_pages, cfg.n_kv_heads, page_size, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _write_kv_paged(pool, delta, pos, pages, page_size: int) -> None:
    """Scatter one decode step's K/V delta (B, KV, 1, D) into one layer's
    pool, in place: logical position ``pos[b]`` of slot b lives in physical
    page ``pages[b, pos // ps]`` at offset ``pos % ps``.

    A free slot's length keeps growing with every decode step, so it can
    run past its table (``pos // ps >= n_pages``).  The reference's gather
    then yields an out-of-range page id and its scatter drops the write;
    here such writes are routed to the trash page 0 instead, which is never
    read as anything but zeros — the same observable result.  Free slots
    all write page 0 at once, so its contents are nondeterministic; nothing
    may depend on them."""
    n_pages = pages.shape[1]
    idx = torch.div(pos, page_size, rounding_mode="floor").long()
    inside = idx < n_pages
    pid = pages.gather(1, idx.clamp(max=n_pages - 1)[:, None])[:, 0].long()
    pid = torch.where(inside, pid, torch.zeros_like(pid))
    off = (pos % page_size).long()
    pool[pid, :, off, :] = delta[:, :, 0, :].to(pool.dtype)


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, *, pages: torch.Tensor, page_size: int,
                paged_impl: str = "auto"):
    """One decode step for every slot.  tokens: (B, 1) int; ``pages``
    (B, n_pages) int32 page table on the cache's device.  Every slot, free
    ones included, reads its pages, writes its token's K/V through the
    table and has its ``len`` bumped — free slots' rows point at the trash
    page.  ``paged_impl``: ``auto`` (the kernel on a CUDA cache, the gather
    oracle on the CPU), ``kernel`` or ``ref`` (gather ``gather_pages`` view
    + ``_decode_attn_plus_self``).  Updates the cache in place; returns
    ``(logits (B, 1, V), cache)``."""
    x = embed(cfg, params["embed"], tokens)
    if x.shape[1] != 1:
        raise ValueError("decode_step takes one token per slot (S == 1)")
    pos = cache["len"]
    positions = pos[:, None]
    paged_impl = resolve_impl(paged_impl, cache["k"].device)
    gathered = paged_impl == "ref"
    for i, p in enumerate(params["layers"]):
        kp, vp = cache["k"][i], cache["v"][i]
        if gathered:
            lc = {"k": gather_pages(kp, pages), "v": gather_pages(vp, pages)}
        else:
            lc = {"k_pool": kp, "v_pool": vp, "pages": pages}
        x, (kt, vt) = apply_block(cfg, p, x, positions=positions, cache=lc,
                                  cache_len=pos, paged_impl=paged_impl)
        _write_kv_paged(kp, kt, pos, pages, page_size)
        _write_kv_paged(vp, vt, pos, pages, page_size)
    x = apply_norm(cfg, params["norm_f"], x)
    logits = unembed(cfg, params["embed"], x)
    cache["len"] += 1
    return logits, cache


def _write_kv_chunk_paged(pool, delta, start: int, pages_1d, page_size: int):
    """Write a whole prefill chunk's K/V (1, KV, C, D) into the slot's
    pages, in place.  Chunks are page-aligned (``start`` and C are
    multiples of ``page_size``), so the chunk is C / page_size whole
    pages."""
    C = delta.shape[-2]
    n = C // page_size
    first = start // page_size
    if first + n > pages_1d.shape[0]:
        raise ValueError(f"chunk pages [{first}, {first + n}) run past the "
                         f"table width {pages_1d.shape[0]}")
    pids = pages_1d[first:first + n].long()
    _, KV, _, D = delta.shape
    val = delta[0].reshape(KV, n, page_size, D).transpose(0, 1)
    pool[pids] = val.to(pool.dtype)


def chunk_prefill_step(cfg: ModelConfig, params: dict, cache: dict,
                       tokens: torch.Tensor, *, slot: int, start: int,
                       valid_len: int, pages_row: torch.Tensor,
                       page_size: int):
    """One prompt chunk of a chunked prefill into batch slot ``slot``.

    tokens: (1, C) — the chunk, right-padded to its bucket; ``start`` (a
    host int, page-aligned) is its first logical position, ``valid_len``
    the true token count in it.  The chunk attends over the slot's pages
    before ``start`` (read through ``pages_row``, (1, n_pages)) plus
    itself, and its K/V go into the slot's pages through the same row.
    Padding past ``valid_len`` writes garbage K/V into the slot's own
    pages, never read as valid.  The slot's ``len`` becomes
    ``start + valid_len``.  Updates the cache in place; returns
    ``(logits (1, 1, V) at the true last chunk token, cache)``."""
    x = embed(cfg, params["embed"], tokens)
    C = x.shape[1]
    positions = start + torch.arange(C, device=x.device)
    # pages below ``start`` are all the chunk may read; the reference
    # gathers the whole row and masks positions >= start, which adds only
    # exact zeros
    read = pages_row[:, :start // page_size]
    for i, p in enumerate(params["layers"]):
        kp, vp = cache["k"][i], cache["v"][i]
        lc = ({"k": gather_pages(kp, read), "v": gather_pages(vp, read)}
              if start > 0 else None)
        x, (kt, vt) = apply_block(cfg, p, x, positions=positions, cache=lc,
                                  cache_len=start)
        _write_kv_chunk_paged(kp, kt, start, pages_row[0], page_size)
        _write_kv_chunk_paged(vp, vt, start, pages_row[0], page_size)
    x = apply_norm(cfg, params["norm_f"], x)
    last = x[:, valid_len - 1:valid_len]
    logits = unembed(cfg, params["embed"], last)
    cache["len"][slot] = start + valid_len
    return logits, cache
