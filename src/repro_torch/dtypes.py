"""The port's dtype names and the KV cache's cast.

``DTYPES`` maps a configuration's dtype names to torch dtypes;
``float8_e4m3fn`` is a KV cache's storage only (llama3-405b's
``kv_cache_dtype``), written through :func:`cast_kv` and read widened.
"""
from __future__ import annotations

import torch

__all__ = ["DTYPES", "dtype_of", "cast_kv"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn}

#: the largest magnitude that rounds to a finite e4m3 value (448 and the
#: tie to the even 448)
_E4M3_LIMIT = 464.0


def dtype_of(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r} not supported (pick from "
                         f"{tuple(DTYPES)})")
    return DTYPES[name]


def cast_kv(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in a KV cache's ``dtype``, as the reference's
    ``astype(dtype)`` rounds it.  To float8 e4m3 torch's own cast
    saturates (500 and +inf to 448); JAX's rounds to nearest even and
    gives NaN, of x's sign, to every magnitude that rounds past 448, to
    ±inf and to NaN.  So the in-range bytes come from torch's cast and the
    rest are set to the reference's NaN on a ``uint8`` view.  Every other
    dtype is ``x.to(dtype)``."""
    if dtype != torch.float8_e4m3fn or x.dtype == dtype:
        return x.to(dtype)
    bits = x.to(dtype).view(torch.uint8)
    nan = torch.where(torch.signbit(x), 0xFF, 0x7F).to(torch.uint8)
    bad = ~(x.abs() <= _E4M3_LIMIT)
    return torch.where(bad, nan, bits).view(dtype)
