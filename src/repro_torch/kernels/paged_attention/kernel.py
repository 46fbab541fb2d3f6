"""ctypes binding of the hand-written CUDA paged flash-decode kernel.

The kernel (``csrc/paged_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/paged_attention/kernel.py:paged_attention_kernel``.  The
TPU's layout artefacts are gone: queries arrive as (B, KV, G, D) without
padding G to the sublane, and ``m``/``l`` come out as (B, KV, G) without a
128-lane broadcast.  One call launches two device kernels: a split pass
(each block walks ``pages_per_split`` logical pages of one slot and kv
head) and a merge pass (the log-sum-exp merge of the splits and, for the
decode wrapper, of the current token's self term).  The library is built
at the first launch, never at import (this module must import on machines
with no CUDA toolkit).

``launches`` counts calls of the two entry points (:func:`paged_attention_kernel`
and :func:`paged_decode_kernel`, the only places the kernels are
launched): one a call, although a call launches two device kernels, so a
run can show that its main path went through the kernel.  On meta tensors
(the dry-run) the entry points record :func:`cost` with the operation
counter and return meta outputs, the split partials allocated as on the
card, launching nothing.

The pools (and the current token's kt, vt) come in q's dtype, or as
float8 e4m3 under a bf16 or fp32 q (llama3-405b's ``kv_cache_dtype``):
the kernel reads e4m3 pages, where the reference's wrapper sends float8
pools to its plain path.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...analysis import opcount
from .. import build
from ..runtime import on_card

__all__ = ["cost", "paged_attention_kernel", "paged_decode_kernel",
           "default_pages_per_split", "launches"]

#: number of calls of the entry points since import (or the last reset)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the pools' (and kt's) dtype codes; vt takes any of them
_KV_DTYPES = {**_DTYPES, torch.float8_e4m3fn: 2}
#: Hopper's SM count; the default split aims at two blocks an SM or more
_SMS = 132
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build("paged_attention")))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = (
            [vp] * 10 + [i32] + [vp] * 4 + [i32] * 8
            + [ctypes.c_float, i32, i32, vp])
        lib.paged_attention_launch.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def default_pages_per_split(batch: int, kv_heads: int, n_pages: int) -> int:
    """The largest split of 16, 8, 4, 2 or 1 pages that still gives the
    split pass at least two blocks an SM (B·KV·ceil(n_pages/pps) >= 264);
    1 where none does.  Serving qwen2-1.5b at B 8 (KV 2, 128 pages a slot)
    gets 4: 512 blocks."""
    for pps in (16, 8, 4, 2):
        if batch * kv_heads * -(-n_pages // pps) >= 2 * _SMS:
            return pps
    return 1


def cost(pages, kv_len, *, B, KV, G, D, ps, window, elt,
         kv_elt: int | None = None) -> dict:
    """The kernel's work on these inputs (fp32 operations).  Bytes: K and
    V rows of every page the kernel must read (pages that can hold a
    visible position, the trash page excluded — it reads as zeros) at
    ``kv_elt`` bytes an element (default ``elt``, q's: 1 for e4m3 pools),
    their table entries, q, kv_len, and the fp32 outputs.  Operations: 4*G*D
    per position of a page read (q.k and p.v).  On meta tensors, whose
    values are unknown (the dry-run), every slot's context fills its
    table and no entry is the trash page."""
    n_pages = pages.shape[1]
    if pages.is_meta or kv_len.is_meta:
        tbl = np.ones((B, n_pages), np.int64)
        lens = np.full(B, n_pages * ps, np.int64)
    else:
        tbl = pages.cpu().numpy()
        lens = kv_len.cpu().numpy().astype(np.int64)
    j = np.arange(n_pages)
    run = j[None, :] * ps < lens[:, None]
    if window is not None:
        run &= ~((j[None, :] + 1) * ps - 1 < lens[:, None] + 1 - window)
    n_run = int(run.sum())
    n_read = int((run & (tbl != 0)).sum())
    kv_elt = elt if kv_elt is None else kv_elt
    return {"flops": 4 * n_run * KV * G * ps * D,
            "bytes": (2 * n_read * KV * ps * D * kv_elt + n_run * 4
                      + B * KV * G * D * elt + B * 4
                      + B * KV * G * (D + 2) * 4)}


def _check_device(tensors: dict, dev: torch.device) -> None:
    for name, t in tensors.items():
        if not (t.is_cuda or t.is_meta) or t.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _run(q, k_pool, v_pool, pages, kv_len, *, KV, G, window,
         pages_per_split, scale, kt=None, vt=None):
    """Check the inputs, allocate the partials and outputs, launch both
    passes on the current stream and raise on a refused launch."""
    B, D = q.shape[0], q.shape[-1]
    dev = q.device
    if not isinstance(kv_len, torch.Tensor) or kv_len.shape != (B,):
        raise ValueError(f"kv_len must be a (B,) tensor for batch {B}")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"kv_len must be int32, got {kv_len.dtype}")
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool, "pages": pages,
               "kv_len": kv_len}
    if kt is not None:
        tensors.update(kt=kt, vt=vt)
    _check_device(tensors, dev)
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, "
                        f"bfloat16)")
    if (k_pool.dtype not in (q.dtype, torch.float8_e4m3fn)
            or v_pool.dtype != k_pool.dtype):
        raise TypeError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype}: both "
                        f"q's {q.dtype} or both float8_e4m3fn")
    if pages.dtype != torch.int32:
        raise TypeError("pages must be int32")
    ps = k_pool.shape[2]
    if (k_pool.dim() != 4 or k_pool.shape[1] != KV or k_pool.shape[3] != D
            or v_pool.shape != k_pool.shape):
        raise ValueError(f"pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)} as (P, {KV}, ps, {D})")
    if pages.dim() != 2 or pages.shape[0] != B or pages.shape[1] < 1:
        raise ValueError(f"pages {tuple(pages.shape)} does not match "
                         f"batch {B}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    n_pages = pages.shape[1]
    pps = (default_pages_per_split(B, KV, n_pages) if pages_per_split is None
           else int(pages_per_split))
    if pps < 1:
        raise ValueError(f"pages_per_split {pps} must be >= 1")
    n_split = -(-n_pages // pps)
    f32 = dict(dtype=torch.float32, device=dev)
    acc_p = torch.empty((B, KV, n_split, G, D), **f32)
    m_p = torch.empty((B, KV, n_split, G), **f32)
    l_p = torch.empty((B, KV, n_split, G), **f32)
    if kt is None:
        out = None
        acc = torch.empty((B, KV, G, D), **f32)
        m = torch.empty((B, KV, G), **f32)
        l = torch.empty((B, KV, G), **f32)
        ptrs = (None, None, 0, None, acc.data_ptr(), m.data_ptr(),
                l.data_ptr())
    else:
        out = torch.empty_like(q)
        ptrs = (kt.data_ptr(), vt.data_ptr(), _KV_DTYPES[vt.dtype],
                out.data_ptr(), None, None, None)
    if opcount.active():
        opcount.kernel("paged_attention", cost(
            pages, kv_len, B=B, KV=KV, G=G, D=D, ps=ps, window=window,
            elt=q.element_size(), kv_elt=k_pool.element_size()))
    if not on_card(q):
        return out if kt is not None else (acc, m, l)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            pages.data_ptr(), kv_len.data_ptr(),
            acc_p.data_ptr(), m_p.data_ptr(), l_p.data_ptr(), *ptrs, B, KV,
            G, D, ps, n_pages,
            0 if window is None else int(window), pps, float(scale),
            _DTYPES[q.dtype], _KV_DTYPES[k_pool.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {rc} "
                           f"({lib.paged_attention_error_string(rc).decode()})")
    return out if kt is not None else (acc, m, l)


def paged_attention_kernel(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, pages: torch.Tensor,
                           kv_len: torch.Tensor, *,
                           window: int | None = None,
                           pages_per_split: int | None = None):
    """Launch the kernel on the current stream.

    q: (B, KV, G, D) pre-scaled grouped queries (float32 or bfloat16);
    k/v_pool: (P, KV, ps, D) of q's dtype or float8_e4m3fn; pages: (B, n_pages) int32 with ids
    in [0, P); kv_len: (B,) int32 OLD lengths.  All CUDA, one device,
    contiguous.  ``pages_per_split`` (default
    :func:`default_pages_per_split`) is the launch shape.  Returns fp32
    ``acc`` (B, KV, G, D) and ``m``, ``l`` (B, KV, G) — what
    :func:`.ref.paged_attention_plain` computes."""
    global launches
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} is not (B, KV, G, D)")
    _, KV, G, _ = q.shape
    res = _run(q, k_pool, v_pool, pages, kv_len, KV=KV, G=G, window=window,
               pages_per_split=pages_per_split, scale=1.0)
    launches += on_card(q)
    return res


def paged_decode_kernel(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, pages: torch.Tensor,
                        kv_len: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor, *, scale: float,
                        window: int | None = None,
                        pages_per_split: int | None = None) -> torch.Tensor:
    """The whole decode attention in two launches: q (B, 1, H, D) as the
    layer gives it (scaled by ``scale`` and rounded to its dtype inside
    the split pass), the pools and table as for
    :func:`paged_attention_kernel`, kv_len (B,) int32, kt (B, KV, 1, D)
    in the pools' dtype and vt (B, KV, 1, D) float32, bfloat16 or
    float8_e4m3fn: the current token's K/V, merged as a self term.
    Returns (B, 1, H, D) in q's dtype."""
    global launches
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q {tuple(q.shape)} is not (B, 1, H, D)")
    B, _, H, D = q.shape
    KV = k_pool.shape[1]
    if H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    for name, t in (("kt", kt), ("vt", vt)):
        if t.shape != (B, KV, 1, D):
            raise ValueError(f"{name} {tuple(t.shape)} is not "
                             f"{(B, KV, 1, D)}")
    if kt.dtype != k_pool.dtype:
        raise TypeError(f"kt dtype {kt.dtype} differs from the pools' "
                        f"{k_pool.dtype}")
    if vt.dtype not in _KV_DTYPES:
        raise TypeError(f"vt dtype {vt.dtype} not supported (float32, "
                        f"bfloat16, float8_e4m3fn)")
    res = _run(q, k_pool, v_pool, pages, kv_len, KV=KV, G=H // KV,
               window=window, pages_per_split=pages_per_split, scale=scale,
               kt=kt, vt=vt)
    launches += on_card(q)
    return res
