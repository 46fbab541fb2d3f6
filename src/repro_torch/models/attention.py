"""Attention: GQA + RoPE over dense or paged K/V, for serving and training.

Layouts follow the JAX package: q (B, S, H, D), k/v (B, T, KV, D), dense
cache views (B, KV, T, D), page pools (P, KV, page_size, D).  The
cache-less full-sequence form (training, ``cache=None``) has three
numerically equivalent cores, picked by ``impl``:

* ``dense`` — ``_dense_attn``: materialise the scores (the oracle);
* ``tiled`` — ``_tiled_attn``: online softmax over KV tiles, a Python loop
  over query tiles and, inside, over the KV tiles they can see;
* ``kernel`` (``pallas`` is accepted as its reference name) — the
  hand-written flash-attention kernel (``kernels.flash_attention``) with
  its autograd Function.

``auto`` resolves by the tensor's device, as every kernel wrapper of the
port does: the kernel on CUDA; on the CPU the reference's rule, ``dense``
up to S·T = 4096²/4 and ``tiled`` beyond.  ``ref`` takes that plain rule
on any device, as the kernel wrappers' ``ref`` does (so one ``impl="ref"``
runs a hybrid model's attention and SSM layers both on their plain
paths).  (The reference's ``auto``
never picks its Pallas kernel, which ``jax.grad`` cannot differentiate.)

Three forms serve the paged engine:

* ``_dense_attn`` — the first chunk of a prompt (nothing cached yet),
* ``_chunk_attn_with_cache`` — later chunks: prior cache entries plus the
  chunk itself,
* decode — one token against the cache plus its own K/V, either through
  the paged flash-decode kernel (``kernels.paged_attention``, straight on
  the pool) or, on the reference path, ``gather_pages`` followed by
  ``_decode_attn_plus_self``.

The dense engine's batched prefill (S > 1 into a fresh per-slot cache)
reads no cache: the prompt attends over its own K/V through the core
``impl`` picks, as the cache-less form does — so on CUDA ``auto`` runs the
flash kernel here too (the reference's cached branch only ever runs its
plain cores).  Its decode (S == 1 over the dense views) is
``_decode_attn_plus_self``, plain, as in the reference.

Cross-attention (whisper's decoder, ``kv_x=`` the encoder output) projects
K/V from ``kv_x`` on every call (no cross-K/V cache, as in the reference),
uses no RoPE and no mask, and runs the cache-less core that ``impl``
resolves to for S queries over T frames: the flash kernel on CUDA under
``auto``, with S != T.  (The reference's cross-attention never reaches its
Pallas kernel; its ``auto`` takes the plain cores.)

Cache writes stay deltas: ``attention`` returns the step's own K/V and the
caller writes them into the pool.

Tensor parallelism (the serving mesh's ``model`` axis, DESIGN.md §13)
splits a layer by head: ``split_attention`` gives shard i of n its query
heads, its KV heads (a GQA group never straddles two shards), the matching
columns of q/k/v and rows of o; ``attention_tp`` runs every shard on its
own device over its own cache and sums the partial output projections in
shard order.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as fa_ops
from ..kernels.paged_attention import ops as pa_ops
from ..kernels.runtime import resolve_impl
from .config import ModelConfig
from .layers import (apply_norm, apply_rope, dense, dtype_of, init_dense,
                     init_norm, rope_freqs)

__all__ = ["NEG_INF", "ATTN_IMPLS", "init_attention", "attention",
           "attention_tp", "split_attention", "gather_pages",
           "resolve_attn_impl"]

NEG_INF = -2.3819763e38  # large negative for bf16-safe masking

#: ``impl`` values of the cache-less attention core
ATTN_IMPLS = ("auto", "dense", "tiled", "kernel", "pallas", "ref")


def init_attention(generator, cfg: ModelConfig, device) -> dict:
    """q/k/v/o projections (and the qk-norm scales).  A cross-attention
    layer has the same parameters: its K/V read the encoder output."""
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    p = {
        "q": init_dense(generator, d, H * hd, cfg, device, bias=cfg.qkv_bias),
        "k": init_dense(generator, d, KV * hd, cfg, device, bias=cfg.qkv_bias),
        "v": init_dense(generator, d, KV * hd, cfg, device, bias=cfg.qkv_bias),
        "o": init_dense(generator, H * hd, d, cfg, device,
                        scale=1.0 / math.sqrt(H * hd)),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_norm(cfg, device, hd)
        p["k_norm"] = init_norm(cfg, device, hd)
    return p


def _mask_bias(q_pos, k_pos, *, causal: bool, window: int | None, dtype):
    """(q, k) additive bias: 0 where attendable, NEG_INF elsewhere."""
    rel = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones(rel.shape, dtype=torch.bool, device=rel.device)
    if causal:
        ok = ok & (rel >= 0)
    if window is not None:
        ok = ok & (rel < window)
    return torch.where(ok, 0.0, NEG_INF).to(dtype)


def _dense_attn(q, k, v, q_pos, k_pos, *, causal, window):
    """q: (B, S, H, D); k/v: (B, T, KV, D).  Scores in fp32, the mask
    added."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.float() * (1.0 / math.sqrt(D))
    qg = qf.reshape(B, S, KV, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    scores = scores + _mask_bias(q_pos, k_pos, causal=causal, window=window,
                                 dtype=scores.dtype)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def _tiled_attn(q, k, v, q_pos, k_pos, *, causal, window,
                q_tile: int = 1024, kv_tile: int = 1024):
    """Flash-style: online softmax over KV tiles; Python loops over query
    tiles and, inside, over the KV tiles a query tile can see (the
    reference's static triangular schedule, its ``lax.scan`` a loop).
    Inputs are padded to tile multiples: padded queries get position -1,
    padded keys 2**30 (unattendable under the causal mask)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_tile = min(q_tile, S)
    kv_tile = min(kv_tile, T)
    Sp, Tp = -(-S // q_tile) * q_tile, -(-T // kv_tile) * kv_tile
    qp = F.pad(q, (0, 0, 0, 0, 0, Sp - S))
    kp = F.pad(k, (0, 0, 0, 0, 0, Tp - T))
    vp = F.pad(v, (0, 0, 0, 0, 0, Tp - T))
    qpos = F.pad(q_pos, (0, Sp - S), value=-1)
    kpos = F.pad(k_pos, (0, Tp - T), value=2**30)
    nq, nk = Sp // q_tile, Tp // kv_tile
    kp = kp.reshape(B, nk, kv_tile, KV, D)
    vp = vp.reshape(B, nk, kv_tile, KV, D)
    kpos_t = kpos.reshape(nk, kv_tile)
    scale = 1.0 / math.sqrt(D)

    outs = []
    for i in range(nq):
        qi = qp[:, i * q_tile:(i + 1) * q_tile].float() * scale
        qi = qi.reshape(B, q_tile, KV, G, D)
        qpos_i = qpos[i * q_tile:(i + 1) * q_tile]
        # causal: kv tiles strictly after this q tile are never attended
        hi = nk if not causal else min(nk, -(-((i + 1) * q_tile) // kv_tile))
        # sliding window: tiles entirely before the window start are masked
        lo = 0
        if window is not None and causal:
            lo = max(0, (i * q_tile - window - kv_tile + 1) // kv_tile)
        m = torch.full((B, KV, G, q_tile), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, G, q_tile), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, KV, G, q_tile, D), dtype=torch.float32,
                          device=q.device)
        for j in range(lo, hi):
            s = torch.einsum("bqkgd,btkd->bkgqt", qi, kp[:, j].float())
            s = s + _mask_bias(qpos_i, kpos_t[j], causal=causal,
                               window=window, dtype=s.dtype)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p, vp[:, j].float())
            m = m_new
        o = acc / l.clamp_min(1e-37)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, q_tile, H, D))
    out = torch.cat(outs, dim=1)[:, :S]
    return out.to(q.dtype)


def resolve_attn_impl(impl: str, device, S: int, T: int) -> str:
    """Map an ``impl`` of :data:`ATTN_IMPLS` to ``dense``, ``tiled`` or
    ``kernel`` for S queries over T keys on ``device``."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; pick from "
                         f"{ATTN_IMPLS}")
    if impl in ("dense", "tiled"):
        return impl
    if resolve_impl("kernel" if impl == "pallas" else impl,
                    device) == "kernel":
        return "kernel"
    return "dense" if S * T <= 4096 * 4096 // 4 else "tiled"


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Assemble per-slot contiguous K/V views from one layer's page pool.

    pool: (P, KV, page_size, D); page_table: (B, n_pages) int — logical page
    i of slot b lives in physical page ``page_table[b, i]``.  Returns
    (B, KV, n_pages*page_size, D).  Rows gathered from page 0 — the trash
    page, whose contents are arbitrary (NaN included) — are zeroed by
    select, so a mid-prefill slot's view matches a dense cache's zero
    tail."""
    g = pool[page_table.long()]                          # (B, n, KV, ps, D)
    g = torch.where((page_table == 0)[:, :, None, None, None],
                    torch.zeros((), dtype=g.dtype, device=g.device), g)
    B, n, KV, ps, D = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, KV, n * ps, D)


def _chunk_attn_with_cache(q, k_cache, v_cache, start: int, kt, vt, *,
                           window: int | None = None):
    """Chunked-prefill attention: a prompt chunk at positions
    ``start .. start+C-1`` attends over the cache entries before ``start``
    plus itself (causal within the chunk).

    q: (B, C, H, D); k_cache/v_cache: (B, KV, T, D) views; kt/vt:
    (B, KV, C, D).  ``start`` is a host int.  The first chunk
    (``start == 0``) reads no cache and goes through ``_dense_attn`` (q in
    fp32, mask added); later chunks score q rounded to the compute dtype
    against cache and chunk, the mask applied by select — the two branches
    of the reference, casts included."""
    B, C, H, D = q.shape
    KV = kt.shape[1]
    G = H // KV
    q_pos = start + torch.arange(C, device=q.device)
    if start == 0:
        return _dense_attn(q, kt.transpose(1, 2), vt.transpose(1, 2),
                           q_pos, q_pos, causal=True, window=window)
    T = k_cache.shape[2]
    if k_cache.dtype != q.dtype:
        k_cache, v_cache = k_cache.to(q.dtype), v_cache.to(q.dtype)
        kt, vt = kt.to(q.dtype), vt.to(q.dtype)
    scale = 1.0 / math.sqrt(D)
    qf = (q.reshape(B, C, KV, G, D) * scale).to(q.dtype).float()
    rel = q_pos[:, None] - q_pos[None, :]
    valid_self = rel >= 0
    if window is not None:
        valid_self = valid_self & (rel < window)
    t_pos = torch.arange(T, device=q.device)
    s_old = torch.einsum("bckgd,bktd->bkgct", qf, k_cache.float())
    valid_old = (t_pos[None, :] < start).expand(C, T)
    if window is not None:
        valid_old = valid_old & (q_pos[:, None] - t_pos[None, :] < window)
    s_old = torch.where(valid_old, s_old, NEG_INF)
    s_self = torch.einsum("bckgd,bksd->bkgcs", qf, kt.float())
    s_self = torch.where(valid_self, s_self, NEG_INF)
    w = torch.softmax(torch.cat([s_old, s_self], dim=-1), dim=-1)
    w_old, w_self = w[..., :T], w[..., T:]
    out = torch.einsum("bkgct,bktd->bckgd", w_old.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out + torch.einsum("bkgcs,bksd->bckgd", w_self.to(vt.dtype).float(),
                             vt.float())
    return out.reshape(B, C, H, D).to(q.dtype)


def _decode_attn_plus_self(q, k_cache, v_cache, kv_len_old, kt, vt, *,
                           window: int | None = None):
    """Decode attention over the OLD cache entries plus the just-computed
    token's own K/V (kt/vt, (B, KV, 1, D)), merged by log-sum-exp, so the
    cache write happens outside as a pure delta."""
    B, _, H, D = q.shape
    KV, T = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    if k_cache.dtype != q.dtype:
        k_cache, v_cache = k_cache.to(q.dtype), v_cache.to(q.dtype)
        kt, vt = kt.to(q.dtype), vt.to(q.dtype)
    scale = 1.0 / math.sqrt(D)
    qf = (q.reshape(B, KV, G, D) * scale).to(q.dtype).float()
    s_old = torch.einsum("bkgd,bktd->bkgt", qf, k_cache.float())
    pos = torch.arange(T, device=q.device)[None, :]
    kv_len_old = torch.as_tensor(kv_len_old, device=q.device).reshape(-1, 1)
    valid = pos < kv_len_old
    if window is not None:
        valid = valid & (pos >= kv_len_old + 1 - window)
    s_old = torch.where(valid[:, None, None, :], s_old, NEG_INF)
    s_self = torch.einsum("bkgd,bktd->bkgt", qf, kt.float())[..., 0]
    m = torch.maximum(s_old.amax(dim=-1), s_self)
    p_old = torch.exp(s_old - m[..., None])
    p_self = torch.exp(s_self - m)
    l = p_old.sum(dim=-1) + p_self
    out = torch.einsum("bkgt,bktd->bkgd", p_old.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out + p_self[..., None] * vt[:, :, 0, :].float()[:, :, None, :]
    out = out / l[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype)


def _attn_core(q, k, v, q_pos, k_pos, *, causal, window, impl):
    """q (B, S, H, D) over k/v (B, T, KV, D) with no cache, through the
    core ``impl`` resolves to for S x T: the sequence over its own K/V
    (``k_pos`` is ``q_pos``), or cross-attention over T encoder frames.
    The kernel takes query and key positions from 0, as every caller's
    are."""
    core = resolve_attn_impl(impl, q.device, q.shape[1], k.shape[1])
    if core == "kernel":
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      impl="kernel")
    if core == "dense":
        return _dense_attn(q, k, v, q_pos, k_pos, causal=causal,
                           window=window)
    return _tiled_attn(q, k, v, q_pos, k_pos, causal=causal, window=window)


def attention(cfg: ModelConfig, p: dict, x: torch.Tensor, *, positions,
              cache: dict | None, cache_len=None, window: int | None = None,
              paged_impl: str = "auto", causal: bool = True,
              impl: str = "auto", chunk_continue: bool = False,
              kv_x: torch.Tensor | None = None, rope: bool | None = None):
    """Full attention layer: qkv projection -> RoPE -> core -> output
    projection.  ``rope`` (default ``cfg.use_rope``) turns RoPE on or off.

    ``cache=None`` is the cache-less full-sequence form (training): the
    sequence attends over itself with query and key positions
    ``positions``, through the core ``impl`` picks (see the module
    docstring), and the result is ``(out, None)``.  With ``kv_x`` (B, T, d)
    it is cross-attention: K/V are projected from ``kv_x`` at key
    positions ``arange(T)``, RoPE (if on) rotates the queries only, and
    the result is ``(out, None)``.

    Otherwise it runs against one layer's cache and returns ``(out, (kt,
    vt))`` — the step's K/V in the cache layout (B, KV, S, D), for the
    caller to write.  ``cache`` takes one of two forms.  On the paged decode path (S == 1,
    ``{"k_pool", "v_pool", "pages"}``) the pools and page table go straight
    to the paged flash-decode wrapper, whose ``paged_impl`` picks the
    kernel (by the tensor's device) or the gather oracle.  Otherwise it
    holds dense views ``{"k", "v"}`` (or is empty for a first chunk):
    S == 1 is decode over the view; S > 1 with ``chunk_continue`` a prefill
    chunk starting at the host int ``cache_len``, and without it the dense
    engine's batched prefill from a fresh cache (positions ``cache_len +
    arange(S)``, no cache read, the core ``impl`` picks)."""
    cd = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rope = cfg.use_rope if rope is None else rope
    if kv_x is not None and cache is not None:
        raise ValueError("cross-attention (kv_x) takes no cache: its K/V "
                         "are recomputed from kv_x on every call")

    src = x if kv_x is None else kv_x
    q = dense(p["q"], x, cd).reshape(B, S, H, hd)
    k = dense(p["k"], src, cd).reshape(B, src.shape[1], KV, hd)
    v = dense(p["v"], src, cd).reshape(B, src.shape[1], KV, hd)
    if cfg.qk_norm:
        q = apply_norm(cfg, p["q_norm"], q)
        k = apply_norm(cfg, p["k_norm"], k)
    if rope:
        sin, cos = rope_freqs(cfg, positions, hd)
        q = apply_rope(q, sin, cos)
        if kv_x is None:
            k = apply_rope(k, sin, cos)

    if cache is None:
        pos = positions[0] if positions.dim() > 1 else positions
        k_pos = (pos if kv_x is None
                 else torch.arange(k.shape[1], device=q.device))
        out = _attn_core(q, k, v, pos, k_pos, causal=causal, window=window,
                         impl=impl)
        return dense(p["o"], out.reshape(B, S, H * hd), cd), None

    store = cache.get("k_pool", cache.get("k")) if cache else None
    kv_dtype = store.dtype if store is not None else dtype_of(
        cfg.kv_cache_dtype or cfg.compute_dtype)
    kt = k.transpose(1, 2).to(kv_dtype)                    # (B, KV, S, D)
    vt = v.transpose(1, 2).to(kv_dtype)
    if S == 1 and cache and "k_pool" in cache:
        out = pa_ops.paged_decode_attention(
            q, cache["k_pool"], cache["v_pool"], cache["pages"], cache_len,
            kt, vt, window=window, impl=paged_impl)
    elif S == 1:
        out = _decode_attn_plus_self(q, cache["k"], cache["v"], cache_len,
                                     kt, vt, window=window)
    elif not chunk_continue:
        q_pos = cache_len + torch.arange(S, device=q.device)
        out = _attn_core(q, k, v, q_pos, q_pos, causal=True, window=window,
                         impl=impl)
    else:
        kc = cache["k"] if cache else None
        vc = cache["v"] if cache else None
        out = _chunk_attn_with_cache(q, kc, vc, int(cache_len), kt, vt,
                                     window=window)
    out = dense(p["o"], out.reshape(B, S, H * hd), cd)
    return out, (kt, vt)


def split_attention(cfg: ModelConfig, p: dict, n: int, i: int):
    """Shard ``i`` of ``n`` of one attention layer's parameters, split by
    head: query heads ``[i·H/n, (i+1)·H/n)`` and KV heads ``[i·KV/n,
    (i+1)·KV/n)`` — the query heads of those KV heads' groups —, the
    matching columns of q/k/v (weights and biases) and rows of o.  o's
    bias goes to shard 0 alone, so :func:`attention_tp`'s sum adds it
    once.  The qk-norm scales are per head dim and shared by every shard.
    Returns ``(cfg_s, p_s)``: ``cfg_s`` has the shard's head counts and
    pins ``head_dim`` (``cfg.hd`` falls back to d_model // n_heads).  One
    shard of one is the layer itself, ``(cfg, p)``: no copy."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if H % n or KV % n or not 0 <= i < n:
        raise ValueError(f"shard {i} of {n} does not split {H} query and "
                         f"{KV} KV heads")
    if n == 1:
        return cfg, p
    hq, hk = H // n, KV // n

    def cols(d: dict, heads: int) -> dict:
        lo, hi = i * heads * hd, (i + 1) * heads * hd
        out = {"w": d["w"][:, lo:hi].contiguous()}
        if "b" in d:
            out["b"] = d["b"][lo:hi].contiguous()
        return out

    o = {"w": p["o"]["w"][i * hq * hd:(i + 1) * hq * hd].contiguous()}
    if i == 0 and "b" in p["o"]:
        o["b"] = p["o"]["b"]
    p_s = {**p, "q": cols(p["q"], hq), "k": cols(p["k"], hk),
           "v": cols(p["v"], hk), "o": o}
    return dataclasses.replace(cfg, n_heads=hq, n_kv_heads=hk,
                               head_dim=hd), p_s


def attention_tp(shards, x: torch.Tensor, *, caches: list, positions,
                 cache_len=None, **kw):
    """One attention layer over tensor-parallel shards.  ``shards``:
    ``(cfg_s, p_s, device)`` of each shard (:func:`split_attention`), in
    shard order; ``caches``: each shard's cache, in a form ``attention``
    takes, on its device.  Each shard runs its heads on its device (x,
    positions and a tensor ``cache_len`` moved there), and the partial
    output projections are summed in shard order on x's device (shard 0's
    carries o's bias); one shard is ``attention`` itself.  The other
    keywords go to ``attention``, a cross-attention's ``kv_x`` moved to
    each shard's device.  Returns ``(out, [(kt, vt) of each shard on its
    device])`` for the caller to write into the shards' pools."""
    outs, kvs = [], []
    kv_x = kw.pop("kv_x", None)
    for (cfg_s, p_s, dev), cache in zip(shards, caches, strict=True):
        clen = (cache_len.to(dev) if isinstance(cache_len, torch.Tensor)
                else cache_len)
        if kv_x is not None:
            kw["kv_x"] = kv_x.to(dev)
        out, kv = attention(cfg_s, p_s, x.to(dev),
                            positions=positions.to(dev), cache=cache,
                            cache_len=clen, **kw)
        outs.append(out.to(x.device))
        kvs.append(kv)
    out = outs[0]
    for part in outs[1:]:
        out = out + part
    return out, kvs
