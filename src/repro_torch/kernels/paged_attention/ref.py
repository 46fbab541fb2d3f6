"""Plain PyTorch versions of the paged flash-decode kernel.

Two functions, at two levels:

* :func:`paged_attention_plain` computes exactly what the CUDA kernel
  emits — the unnormalised ``(acc, m, l)`` of an online softmax that walks
  each slot's logical pages in order, skipping and masking them as the
  kernel does — so kernel and plain version can be held against each other
  before the self-term merge;
* :func:`paged_decode_attention_ref` is the gather-then-dense oracle of the
  whole wrapper: assemble each slot's contiguous K/V view from the pool
  (trash-page rows zeroed) and run the decode-plus-self-term math of
  ``models.attention._decode_attn_plus_self``.

Both are the CPU path of :func:`..ops.paged_decode_attention`; on the card
they run only when asked for by name.  Two more spell out the kernel's
split plan, for the tests: :func:`paged_attention_split_plain` gives each
split of ``pages_per_split`` logical pages its own partial
``(acc, m, l)``, and :func:`merge_splits_plain` merges the partials (and,
given ``kt``/``vt``, the self term) as the merge pass does.  Nothing on the
serving path calls them.
"""
from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "gather_pages_ref", "paged_attention_plain",
           "paged_attention_split_plain", "merge_splits_plain",
           "paged_decode_attention_ref"]

NEG_INF = -2.3819763e38


def gather_pages_ref(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """pool: (P, KV, ps, D); pages: (B, n) int -> (B, KV, n*ps, D).  Rows
    gathered from physical page 0 (the reserved trash page) are zeroed by
    select, never by a product: its contents are scratch and may be NaN."""
    g = pool[pages.long()]                                # (B, n, KV, ps, D)
    g = torch.where((pages == 0)[:, :, None, None, None],
                    torch.zeros((), dtype=pool.dtype, device=pool.device), g)
    B, n, KV, ps, D = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, KV, n * ps, D)


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, pages: torch.Tensor,
                          kv_len: torch.Tensor, window: int | None = None):
    """The kernel's function, in torch.

    q: (B, KV, G, D) pre-scaled grouped queries; k/v_pool: (P, KV, ps, D);
    pages: (B, n) int32; kv_len: (B,) int32 OLD lengths.  Returns fp32
    ``acc`` (B, KV, G, D), running max ``m`` and denominator ``l``
    (B, KV, G).  Page ``j`` of slot ``b`` runs only when it can hold a
    valid position (``j*ps < kv_len``, and with a window
    ``(j+1)*ps - 1 >= kv_len + 1 - window``); inside a running page,
    positions past ``kv_len`` or before the window are NEG_INF, and the
    trash page reads as zeros."""
    return _walk_pages(q, k_pool, v_pool, pages, kv_len, window, 0,
                       pages.shape[1])


def _walk_pages(q, k_pool, v_pool, pages, kv_len, window, j0: int, j1: int):
    """The online softmax over logical pages ``j0 <= j < j1`` of every
    slot, each page skipped and masked as the kernel does."""
    B, KV, G, D = q.shape
    ps = k_pool.shape[2]
    qf = q.float()
    kv_len = kv_len.reshape(-1).to(torch.int64)
    m = torch.full((B, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, D), dtype=torch.float32, device=q.device)
    t = torch.arange(ps, device=q.device)
    for j in range(j0, j1):
        run = j * ps < kv_len                                          # (B,)
        if window is not None:
            run = run & ((j + 1) * ps - 1 >= kv_len + 1 - window)
        pid = pages[:, j].long()
        trash = (pid == 0)[:, None, None, None]
        zero = torch.zeros((), dtype=torch.float32, device=q.device)
        k = torch.where(trash, zero, k_pool[pid].float())             # (B,KV,ps,D)
        v = torch.where(trash, zero, v_pool[pid].float())
        s = torch.einsum("bkgd,bktd->bkgt", qf, k)
        pos = j * ps + t                                               # (ps,)
        ok = pos[None, :] < kv_len[:, None]                            # (B, ps)
        if window is not None:
            ok = ok & (pos[None, :] >= kv_len[:, None] + 1 - window)
        s = torch.where(ok[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum("bkgt,bktd->bkgd", p, v)
        r = run[:, None, None]
        m = torch.where(r, m_new, m)
        l = torch.where(r, l_new, l)
        acc = torch.where(r[..., None], acc_new, acc)
    return acc, m, l


def paged_attention_split_plain(q, k_pool, v_pool, pages, kv_len,
                                window: int | None = None, *,
                                pages_per_split: int):
    """The split pass in torch: split ``s`` walks logical pages
    ``[s*pps, (s+1)*pps)`` alone.  Inputs as :func:`paged_attention_plain`;
    returns fp32 ``acc_s`` (B, KV, n_split, G, D) and ``m_s``, ``l_s``
    (B, KV, n_split, G), ``n_split = ceil(n_pages / pps)``.  A split with
    no running page is empty: m NEG_INF, l 0, acc 0."""
    n_pages = pages.shape[1]
    parts = [_walk_pages(q, k_pool, v_pool, pages, kv_len, window, j0,
                         min(j0 + pages_per_split, n_pages))
             for j0 in range(0, n_pages, pages_per_split)]
    return tuple(torch.stack(t, dim=2) for t in zip(*parts))


def merge_splits_plain(acc_s, m_s, l_s, *, q=None, kt=None, vt=None):
    """The merge pass in torch: the log-sum-exp merge of the partials of
    :func:`paged_attention_split_plain` into ``(acc, m, l)`` (what
    :func:`paged_attention_plain` gives).  Given q (B, KV, G, D) pre-scaled
    in its dtype and the current token's kt, vt (B, KV, 1, D), also the
    self term, then the normalised (B, 1, H, D) output in q's dtype, as
    the decode wrapper returns it."""
    m = m_s.amax(dim=2)
    w = torch.exp(m_s - m[:, :, None])
    l = (w * l_s).sum(dim=2)
    acc = (w[..., None] * acc_s).sum(dim=2)
    if kt is None:
        return acc, m, l
    B, KV, G, D = q.shape
    s_self = torch.einsum("bkgd,bktd->bkgt", q.float(),
                          kt.to(q.dtype).float())[..., 0]
    m_tot = torch.maximum(m, s_self)
    alpha = torch.exp(m - m_tot)
    beta = torch.exp(s_self - m_tot)
    out = alpha[..., None] * acc + beta[..., None] * vt[:, :, 0, :].float()[
        :, :, None, :]
    out = out / (alpha * l + beta)[..., None]
    return out.reshape(B, 1, KV * G, D).to(q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, pages, kv_len, kt, vt, *,
                               window: int | None = None) -> torch.Tensor:
    """q: (B, 1, H, D); pools: (P, KV, ps, D); pages: (B, n) int32;
    kv_len: scalar or (B,) OLD cache lengths; kt/vt: (B, KV, 1, D) the
    current token's K/V (merged as a self term).  Returns (B, 1, H, D)."""
    k_cache = gather_pages_ref(k_pool, pages)
    v_cache = gather_pages_ref(v_pool, pages)
    B, _, H, D = q.shape
    KV, T = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    if k_cache.dtype != q.dtype:
        k_cache, v_cache = k_cache.to(q.dtype), v_cache.to(q.dtype)
        kt, vt = kt.to(q.dtype), vt.to(q.dtype)
    scale = 1.0 / math.sqrt(D)
    qf = (q.reshape(B, KV, G, D) * scale).to(q.dtype)
    s_old = torch.einsum("bkgd,bktd->bkgt", qf.float(), k_cache.float())
    pos = torch.arange(T, device=q.device)[None, :]
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1)
    kv_len = kv_len.expand(B)[:, None]
    valid = pos < kv_len
    if window is not None:
        valid = valid & (pos >= kv_len + 1 - window)
    s_old = torch.where(valid[:, None, None, :], s_old, NEG_INF)
    s_self = torch.einsum("bkgd,bktd->bkgt", qf.float(), kt.float())[..., 0]
    m = torch.maximum(s_old.amax(dim=-1), s_self)
    p_old = torch.exp(s_old - m[..., None])
    p_self = torch.exp(s_self - m)
    l = p_old.sum(dim=-1) + p_self
    out = torch.einsum("bkgt,bktd->bkgd", p_old.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out + p_self[..., None] * vt[:, :, 0, :].float()[:, :, None, :]
    out = out / l[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype)
