"""ctypes bindings of the hand-written CUDA flash-attention kernels.

The forward (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention_kernel``.  It
reads q (B, S, H, D) and k/v (B, T, KV, D) in the model layout through
their strides (last dimension contiguous), so the TPU wrapper's transposes
are gone, masks ragged S and T itself, and also writes the fp32 per-row
log-sum-exp (B, H, S) that the backward pass needs.  bf16 runs on the
tensor cores (``wgmma``, tiles brought by TMA), at the launch shape
``(q_block, kv_block)``; fp32 on plain FMA at one fixed shape.  It takes
head dims that are multiples of 8 up to 256 (gemma3's 256 among them); at
D > 128 the bf16 kernel's tiles are 64 keys (:func:`check_blocks`).

The backward (``csrc/flash_attention_bwd.cu``) has no Pallas counterpart:
the reference differentiates its plain paths.  It computes dq, dk and dv
from the forward's output and LSE in three device kernels a call (the
rowsum of dO∘O, the dK/dV pass, the dQ pass; in bf16 on TMA, an mbarrier
ring and ``wgmma``, in fp32 on FMA), with no atomics, at the forward's
head dims (up to 256; at D > 128 the bf16 dK/dV pass gives dK and dV to
separate warpgroups).

Libraries are built at the first launch, never at import (this module must
import on machines with no CUDA toolkit).  ``launches`` counts calls of
:func:`flash_attention_kernel` (``flash_attention``) and of
:func:`flash_attention_backward_kernel` (``flash_attention_bwd``, one a
call, although a call launches three device kernels), the one place each
is launched, so a run can show that its main path went through them.  On
meta tensors (the dry-run) both functions record :func:`cost` with the
operation counter and return meta outputs, launching nothing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...analysis import opcount
from .. import build
from ..runtime import on_card

__all__ = ["BLOCKS", "DEFAULT_Q_BLOCK", "DEFAULT_KV_BLOCK", "MAX_D",
           "MAX_D_BWD", "WIDE_D", "WIDE_Q_BLOCK", "check_blocks",
           "cost", "default_blocks", "flash_attention_kernel",
           "flash_attention_backward_kernel", "launches", "visible_pairs"]

#: kernel name -> calls since import (or the last reset)
launches = {"flash_attention": 0, "flash_attention_bwd": 0}

#: the launch shapes the bf16 forward takes, for q_block and kv_block
BLOCKS = (64, 128)
#: the bf16 forward's launch shape when neither the caller nor the tuner
#: gives one: the fastest of the grid at the training shape (B 2, S 4096,
#: H 12, KV 2, D 128, causal) on an H100
DEFAULT_Q_BLOCK = 64
DEFAULT_KV_BLOCK = 64
#: the widest head dim of the forward and of the backward
MAX_D = 256
MAX_D_BWD = 256
#: head dims above this take 64-key tiles only: a 128-key K and V tile of
#: D 256 (64 KB each) leaves no room for a second stage
WIDE_D = 128
#: the bf16 forward's query rows above ``WIDE_D`` when neither the caller
#: nor the tuner gives them: the faster of its two launch shapes at
#: gemma3-4b's batched prefill (B 8, S 2,048, H 8, KV 4, D 256, causal
#: and windowed) on an H100
WIDE_Q_BLOCK = 128


def default_blocks(D: int) -> tuple[int, int]:
    """``(q_block, kv_block)`` of the bf16 forward at head dim ``D`` when
    neither the caller nor the tuner gives one."""
    return (WIDE_Q_BLOCK if D > WIDE_D else DEFAULT_Q_BLOCK,
            DEFAULT_KV_BLOCK)

_DTYPES = (torch.float32, torch.bfloat16)
_libs: dict[str, ctypes.CDLL] = {}


def _load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        lib = ctypes.CDLL(str(build.build(name)))
        if name == "flash_attention":
            lib.flash_attention_launch.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
                + [ctypes.c_int] * 11 + [ctypes.c_void_p])
            lib.flash_attention_launch.restype = ctypes.c_int
        else:
            lib.flash_attention_bwd_launch.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
            lib.flash_attention_bwd_launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def check_blocks(q_block: int | None, kv_block: int | None,
                 D: int | None = None) -> None:
    """Raise ``ValueError`` unless each given block is in :data:`BLOCKS`,
    and, at a head dim ``D`` above :data:`WIDE_D`, ``kv_block`` is 64."""
    for name, val in (("q_block", q_block), ("kv_block", kv_block)):
        if val is not None and val not in BLOCKS:
            raise ValueError(f"{name} {val} not in the kernel's launch "
                             f"shapes {BLOCKS}")
    if D is not None and D > WIDE_D and kv_block not in (None, 64):
        raise ValueError(f"kv_block {kv_block} not taken at head dim {D} "
                         f"(64 above {WIDE_D})")


def visible_pairs(S: int, T: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the masks leave visible, for these sizes."""
    i = np.arange(S)
    hi = np.minimum(i + 1, T) if causal else np.full(S, T)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(S, int)
    return int(np.maximum(hi - lo, 0).sum())


def cost(B, S, T, H, KV, D, causal, window, dtype, *,
         backward: bool = False) -> dict:
    """The forward's work on these sizes: 4·D operations per visible pair
    (q·k and p·v), q, k, v read once and the output and fp32 LSE written
    once.  ``backward``: 10·D operations per visible pair (q·k and dO·vᵀ
    recomputed, dV, dQ, dK), q, k, v, O, dO and LSE read once and dq, dk,
    dv written once.  The operations run on the dtype's units (tensor
    cores for bf16, FMA for fp32)."""
    elt = torch.tensor([], dtype=dtype).element_size()
    pairs = visible_pairs(S, T, causal, window)
    if backward:
        return {"flops": 10 * B * H * D * pairs,
                "bytes": ((4 * B * S * H * D + 4 * B * T * KV * D) * elt
                          + B * H * S * 4)}
    return {"flops": 4 * B * H * D * pairs,
            "bytes": ((2 * B * S * H * D + 2 * B * T * KV * D) * elt
                      + B * H * S * 4)}


def _check(q, k, v, *extra, max_d: int = MAX_D) -> None:
    """Shapes and dtypes first, then the device: q (B, S, H, D), k/v
    (B, T, KV, D) and every ``(name, tensor)`` in ``extra`` shaped like q,
    one dtype, last dimension contiguous, D a multiple of 8 up to
    ``max_d``, on one CUDA device."""
    named = (("q", q), ("k", k), ("v", v), *extra)
    for name, t in named:
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} differs from q's "
                            f"{q.dtype}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-d with a contiguous last "
                             f"dimension, got shape {tuple(t.shape)} strides "
                             f"{t.stride()}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != D or v.shape != k.shape or KV < 1
            or H % KV):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} as (B, T, KV, D) with H "
                         f"a multiple of KV")
    for name, t in extra:
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)}")
    if not (8 <= D <= max_d and D % 8 == 0):
        raise ValueError(f"head dim {D} not supported by the flash kernel "
                         f"(multiples of 8 up to {max_d})")
    if min(B, S, T) < 1 or B > 65535 or H > 65535:
        raise ValueError(f"unsupported sizes B={B} S={S} T={T} H={H}")
    for name, t in named:
        if not (t.is_cuda or t.is_meta) or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, "
                             f"got {t.device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy where the bf16 kernels' 16-byte copies
    (TMA, cp.async) cannot reach it: a start off 16 bytes or a stride
    that is not a multiple of 8 elements."""
    ok = (t.dtype != torch.bfloat16
          or (t.data_ptr() % 16 == 0
              and all(s % 8 == 0 for s in t.stride()[:3])))
    return t if ok else t.contiguous()


def _strides(*tensors) -> list[int]:
    return [s for t in tensors for s in t.stride()[:3]]


def _raise(lib, name: str, rc: int) -> None:
    msg = getattr(lib, f"{name}_error_string")(rc).decode()
    raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, window: int | None = None,
                           q_block: int | None = None,
                           kv_block: int | None = None):
    """Launch the forward kernel on the current stream.

    q: (B, S, H, D); k/v: (B, T, KV, D) with H a multiple of KV; all CUDA
    on one device, one dtype (float32 or bfloat16), last dimension
    contiguous, D a multiple of 8 up to :data:`MAX_D`.  ``q_block`` and
    ``kv_block`` (in :data:`BLOCKS`, kv_block 64 above :data:`WIDE_D`;
    default :func:`default_blocks`) are the bf16 kernel's launch shape;
    the fp32 kernel has one and ignores them.
    Returns ``(out (B, S, H, D) in q's dtype, lse (B, H, S) fp32)`` — what
    :func:`.ref.flash_attention_plain` computes."""
    _check(q, k, v)
    check_blocks(q_block, kv_block, q.shape[-1])
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    q, k, v = (_aligned(t) for t in (q, k, v))
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    if opcount.active():
        opcount.kernel("flash_attention",
                       cost(B, S, T, H, KV, D, causal, window, q.dtype))
    if not on_card(q):
        return out, lse
    q_default, kv_default = default_blocks(D)
    lib = _load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *_strides(q, k, v, out), B, S, T, H, KV, D,
            int(causal), 0 if window is None else int(window),
            int(q.dtype == torch.bfloat16), q_block or q_default,
            kv_block or kv_default, stream)
    if rc != 0:
        _raise(lib, "flash_attention", rc)
    launches["flash_attention"] += 1
    return out, lse


def flash_attention_backward_kernel(q, k, v, out, lse, dout, *,
                                    causal: bool = True,
                                    window: int | None = None):
    """Launch the backward kernels on the current stream.

    q, out, dout: (B, S, H, D); k/v: (B, T, KV, D); lse: (B, H, S) fp32
    from the forward; all CUDA on one device, q, k, v, out and dout of one
    dtype (float32 or bfloat16), last dimension contiguous, D a multiple
    of 8 up to :data:`MAX_D_BWD` (256: gemma3's head dim; wider is
    refused before any build).  Returns ``(dq, dk, dv)`` in the inputs'
    dtype — what :func:`.ref.flash_attention_backward_plain` computes."""
    B, S, H, D = q.shape
    if lse.dtype != torch.float32 or lse.shape != (B, H, S):
        raise TypeError(f"lse must be float32 of shape {(B, H, S)}, got "
                        f"{lse.dtype} {tuple(lse.shape)}")
    _check(q, k, v, ("out", out), ("dout", dout), max_d=MAX_D_BWD)
    T, KV = k.shape[1], k.shape[2]
    if lse.device != q.device:
        raise ValueError(f"lse must be a CUDA tensor on {q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be >= 1")
    q, k, v, out, dout = (_aligned(t) for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    di = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if opcount.active():
        opcount.kernel("flash_attention_bwd",
                       cost(B, S, T, H, KV, D, causal, window, q.dtype,
                            backward=True))
    if not on_card(q):
        return dq, dk, dv
    tensors = (q, k, v, out, dout, lse, di, dq, dk, dv)
    ptrs = (ctypes.c_void_p * 10)(*(t.data_ptr() for t in tensors))
    strides = (ctypes.c_longlong * 24)(*_strides(q, k, v, out, dout, dq, dk,
                                                 dv))
    dims = (ctypes.c_int * 9)(B, S, T, H, KV, D, int(causal),
                              0 if window is None else int(window),
                              int(q.dtype == torch.bfloat16))
    lib = _load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd_launch(ptrs, strides, dims, stream)
    if rc != 0:
        _raise(lib, "flash_attention_bwd", rc)
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv
