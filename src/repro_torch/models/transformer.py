"""Model composition: the dense GQA decoder family and the attention-free
Mamba-2 (``ssm``) family for serving, and the dense family's full-sequence
forward and loss for training.

Parameters are the JAX package's pytree unstacked: ``{"embed": {"table"},
"layers": [block, ...], "norm_f": {"scale"}}`` with one dict per layer
(the reference stacks layers on a leading axis for ``lax.scan``; here a
plain Python loop runs them).  A dense block is ``{"ln1", "attn", "ln2",
"mlp"}``, an SSM block ``{"ln1", "mixer"}``.  The paged serving cache holds
``"len": (B,) int32`` and, for the attention layers, ``"k"``/``"v"``:
(n_attn, P, KV, ps, D), one page pool per layer and per K/V; for the SSM
layers, per-slot state ``"conv"``: (n_ssm, B, W-1, d_inner + 2N) and
``"state"``: (n_ssm, B, H, P, N), both fp32 (SSM state is O(1) per slot
and has no pages).  ``cache["k"][i]`` is the i-th attention layer's pool,
``cache["state"][i]`` the i-th SSM layer's state.

``forward`` / ``loss_fn`` run the whole sequence with no cache (the
training path); ``cfg.remat == "full"`` recomputes each layer in the
backward pass (``torch.utils.checkpoint``), so its attention kernel runs
twice a layer.

Both serving steps UPDATE THE CACHE IN PLACE (pools, SSM state and ``len``) and
return the same dict — the reference returns a new cache.  Every layer
reads its own pool or state before writing it, and layers never share
one, so the result equals the reference's read-all-then-write order.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.runtime import resolve_impl
from .attention import attention, gather_pages, init_attention
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, dtype_of, embed, init_embedding,
                     init_mlp, init_norm, unembed)
from .ssm import apply_mamba2, init_mamba2, init_ssm_cache, mamba2_decode_step

__all__ = ["LayerPlan", "layer_plan", "layer_kinds", "init_block",
           "apply_block", "init_params", "init_paged_cache", "decode_step",
           "chunk_prefill_step", "check_supported", "check_trainable",
           "forward", "loss_fn"]

#: block kinds the port runs
PORTED_KINDS = ("dense", "ssm")


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


def layer_kinds(cfg: ModelConfig) -> tuple[str, ...]:
    """The block kind of every layer, in the order the layers run."""
    plan = layer_plan(cfg)
    return plan.pattern * plan.n_groups + plan.tail


def check_supported(cfg: ModelConfig) -> None:
    """The port runs the dense family (attention + gated MLP in every
    layer) and the ssm family (a Mamba-2 mixer in every layer); the other
    block kinds come with later slices."""
    plan = layer_plan(cfg)
    missing = sorted(set(plan.pattern + plan.tail) - set(PORTED_KINDS))
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {missing} are not ported yet (the "
            f"port runs {PORTED_KINDS})")


# ---------------------------------------------------------------------------
# Blocks and parameters
# ---------------------------------------------------------------------------


def init_block(generator, cfg: ModelConfig, device, kind: str) -> dict:
    if kind == "ssm":
        return {"ln1": init_norm(cfg, device),
                "mixer": init_mamba2(generator, cfg, device)}
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
            "layers": [init_block(generator, cfg, device, kind)
                       for kind in layer_kinds(cfg)],
            "norm_f": init_norm(cfg, device)}


def apply_block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, *,
                positions, cache: dict | None, cache_len,
                paged_impl: str = "auto", impl: str = "auto",
                valid_len: int | None = None):
    """One pre-norm residual block.

    ``dense`` (attention + gated MLP) returns ``(x, (kt, vt))`` with the
    block's K/V delta; with ``cache=None`` (the full-sequence forward) it
    returns ``(x, None)`` and ``impl`` picks the attention core.  ``ssm`` returns ``(x, new_cache)`` with the slot
    rows' new ``{"conv", "state"}``: one token per row (S == 1) runs the
    decode recurrence; a longer chunk continues the conv and SSD scan from
    ``cache`` (chunked prefill), with positions >= ``valid_len`` masked out
    of the state, and ``impl`` picks its intra-chunk path."""
    if kind == "ssm":
        h = apply_norm(cfg, p["ln1"], x)
        if x.shape[1] == 1:
            out, new_cache = mamba2_decode_step(cfg, p["mixer"], h, cache)
        else:
            out, new_cache = apply_mamba2(cfg, p["mixer"], h, cache=cache,
                                          valid_len=valid_len, impl=impl)
        return x + out, new_cache
    window = cfg.sliding_window
    h = apply_norm(cfg, p["ln1"], x)
    out, kv = attention(cfg, p["attn"], h, positions=positions, cache=cache,
                        cache_len=cache_len, window=window,
                        paged_impl=paged_impl, impl=impl)
    x = x + out
    h = apply_norm(cfg, p["ln2"], x)
    x = x + apply_mlp(cfg, p["mlp"], h)
    return x, kv


# ---------------------------------------------------------------------------
# Full-sequence forward and loss (training)
# ---------------------------------------------------------------------------


def check_trainable(cfg: ModelConfig) -> None:
    """``forward`` and ``loss_fn`` run the dense family; training the other
    families comes with later slices."""
    check_supported(cfg)
    if set(layer_kinds(cfg)) != {"dense"}:
        raise NotImplementedError(f"{cfg.name}: the full-sequence forward "
                                  f"runs the dense family only")
    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(f"remat={cfg.remat!r} is not ported (the "
                                  f"port runs 'none' and 'full')")


def _run_stack(cfg: ModelConfig, layers, x, positions, *, impl: str):
    """Every layer in order, each recomputed in the backward pass under
    ``remat="full"``.  Returns ``(x, aux)``; the dense family has no
    auxiliary loss."""
    for kind, p in zip(layer_kinds(cfg), layers):
        def block(h, p=p, kind=kind):
            return apply_block(cfg, kind, p, h, positions=positions,
                               cache=None, cache_len=None, impl=impl)[0]
        if cfg.remat == "full" and torch.is_grad_enabled():
            x = checkpoint(block, x, use_reentrant=False)
        else:
            x = block(x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(cfg: ModelConfig, params: dict, *, tokens=None, embeds=None,
            positions=None, impl: str = "auto"):
    """Full-sequence forward (train / prefill).  ``tokens`` (B, S) int, or
    ``embeds`` (B, S, d).  Returns ``(logits (B, S, padded_vocab) in the
    compute dtype, aux)``; ``impl`` picks every layer's attention core."""
    check_trainable(cfg)
    if embeds is None:
        x = embed(cfg, params["embed"], tokens)
    else:
        x = embeds.to(dtype_of(cfg.compute_dtype))
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _run_stack(cfg, params["layers"], x, positions, impl=impl)
    x = apply_norm(cfg, params["norm_f"], x)
    return unembed(cfg, params["embed"], x), aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            impl: str = "auto"):
    """Next-token cross-entropy: the mask-weighted mean NLL over
    ``batch["tokens"]`` / ``"labels"`` / ``"mask"`` (optional), with the
    padded vocabulary masked out of the softmax.  Returns ``(total,
    {"loss", "aux", "tokens"})``."""
    logits, aux = forward(cfg, params, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"), impl=impl)
    logits = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e9
    logz = torch.logsumexp(logits, dim=-1)
    labels = batch["labels"].long()
    nll = logz - logits.gather(-1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.float()
    loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    total = loss + cfg.router_aux_weight * aux
    return total, {"loss": loss, "aux": aux, "tokens": mask.sum()}


# ---------------------------------------------------------------------------
# Paged cache and steps
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: ModelConfig, batch: int, *, num_pages: int,
                     page_size: int, device) -> dict:
    """Paged serving cache: one shared page pool (P, KV, page_size, D) per
    attention layer and per K/V, stacked on a leading layer axis; dense
    per-slot conv tail and SSD state per SSM layer, stacked likewise; and
    per-slot lengths.  An attention-free model gets no pool.  Page 0 is
    the trash page."""
    check_supported(cfg)
    kinds = layer_kinds(cfg)
    n_ssm = kinds.count("ssm")
    n_attn = len(kinds) - n_ssm
    cache = {"len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if n_attn:
        dt = dtype_of(cfg.kv_cache_dtype or cfg.compute_dtype)
        shape = (n_attn, num_pages, cfg.n_kv_heads, page_size, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=dt, device=device)
        cache["v"] = torch.zeros(shape, dtype=dt, device=device)
    if n_ssm:
        for key, t in init_ssm_cache(cfg, batch, device).items():
            cache[key] = t[None].repeat((n_ssm,) + (1,) * t.dim())
    return cache


def _write_ssm_state(layer_cache: dict, new: dict, update_mask) -> None:
    """Store an SSM layer's new per-slot state into its cache rows, in
    place; rows where ``update_mask`` (B,) is False keep their state."""
    for key, val in new.items():
        if update_mask is not None:
            m = update_mask.reshape((-1,) + (1,) * (val.dim() - 1))
            val = torch.where(m, val, layer_cache[key])
        layer_cache[key].copy_(val)


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
                paged_impl: str = "auto", update_mask=None):
    """One decode step for every slot.  tokens: (B, 1) int; ``pages``
    (B, n_pages) int32 page table on the cache's device.  Every slot, free
    ones included, reads its pages, writes its token's K/V through the
    table and has its ``len`` bumped — free slots' rows point at the trash
    page.  ``paged_impl``: ``auto`` (the kernel on a CUDA cache, the gather
    oracle on the CPU), ``kernel`` or ``ref`` (gather ``gather_pages`` view
    + ``_decode_attn_plus_self``).  ``update_mask`` (B,) bool: freeze the
    per-slot SSM state of masked-out slots (mid-prefill slots between
    their chunks); None advances every slot.  Updates the cache in place;
    returns ``(logits (B, 1, V), cache)``."""
    x = embed(cfg, params["embed"], tokens)
    if x.shape[1] != 1:
        raise ValueError("decode_step takes one token per slot (S == 1)")
    pos = cache["len"]
    positions = pos[:, None]
    paged_impl = resolve_impl(paged_impl, pos.device)
    gathered = paged_impl == "ref"
    ai = si = 0
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        if kind == "ssm":
            lc = {"conv": cache["conv"][si], "state": cache["state"][si]}
            x, new = apply_block(cfg, kind, p, x, positions=positions,
                                 cache=lc, cache_len=pos)
            _write_ssm_state(lc, new, update_mask)
            si += 1
            continue
        kp, vp = cache["k"][ai], cache["v"][ai]
        ai += 1
        if gathered:
            lc = {"k": gather_pages(kp, pages), "v": gather_pages(vp, pages)}
        else:
            lc = {"k_pool": kp, "v_pool": vp, "pages": pages}
        x, (kt, vt) = apply_block(cfg, kind, p, x, positions=positions,
                                  cache=lc, cache_len=pos,
                                  paged_impl=paged_impl)
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
                       page_size: int, impl: str = "auto"):
    """One prompt chunk of a chunked prefill into batch slot ``slot``.

    tokens: (1, C) — the chunk, right-padded to its bucket; ``start`` (a
    host int, page-aligned) is its first logical position, ``valid_len``
    the true token count in it.  The chunk attends over the slot's pages
    before ``start`` (read through ``pages_row``, (1, n_pages)) plus
    itself, and its K/V go into the slot's pages through the same row.
    Padding past ``valid_len`` writes garbage K/V into the slot's own
    pages, never read as valid.  SSM layers continue from the slot's conv
    tail and state — from zeros on the first chunk (``start == 0``),
    whatever the slot's previous occupant left — with padding masked out
    of the state, and write the new state back into the slot's row;
    ``impl`` picks their intra-chunk SSD path (``auto``: the kernel on
    CUDA, the einsum form on the CPU; ``kernel``; ``ref``).  The slot's
    ``len`` becomes ``start + valid_len``.  Updates the cache in place;
    returns ``(logits (1, 1, V) at the true last chunk token, cache)``."""
    x = embed(cfg, params["embed"], tokens)
    C = x.shape[1]
    positions = start + torch.arange(C, device=x.device)
    # pages below ``start`` are all the chunk may read; the reference
    # gathers the whole row and masks positions >= start, which adds only
    # exact zeros
    read = pages_row[:, :start // page_size]
    ai = si = 0
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        if kind == "ssm":
            rows = {key: cache[key][si, slot:slot + 1]
                    for key in ("conv", "state")}
            # a first chunk starts from zeros: the slot's rows still hold
            # its previous occupant's state
            lc = (rows if start > 0
                  else {k: torch.zeros_like(t) for k, t in rows.items()})
            x, new = apply_block(cfg, kind, p, x, positions=positions,
                                 cache=lc, cache_len=start, impl=impl,
                                 valid_len=valid_len)
            _write_ssm_state(rows, new, None)
            si += 1
            continue
        kp, vp = cache["k"][ai], cache["v"][ai]
        ai += 1
        lc = ({"k": gather_pages(kp, read), "v": gather_pages(vp, read)}
              if start > 0 else {})
        x, (kt, vt) = apply_block(cfg, kind, p, x, positions=positions,
                                  cache=lc, cache_len=start)
        _write_kv_chunk_paged(kp, kt, start, pages_row[0], page_size)
        _write_kv_chunk_paged(vp, vt, start, pages_row[0], page_size)
    x = apply_norm(cfg, params["norm_f"], x)
    last = x[:, valid_len - 1:valid_len]
    logits = unembed(cfg, params["embed"], last)
    cache["len"][slot] = start + valid_len
    return logits, cache
