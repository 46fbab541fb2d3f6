"""Mamba-2 (SSD — state-space duality) blocks, for the serving path.

Chunked SSD (Dao & Gu 2024, §6): the sequence is split into chunks of
length Q; within a chunk the dual quadratic (attention-like) form is used,
and states are carried across chunks by a sequential loop.  The
intra-chunk form is the compute hot spot: on the card it runs the
hand-written kernel (``kernels.ssd_scan``), on the CPU the plain einsum
form below.  Layouts and parameter names are the JAX package's.

The decode recurrence (one token per slot) is plain PyTorch, as it is
plain jnp in the reference.  The causal conv is the reference's shifted
sum of products, not ``F.conv1d``: cuDNN runs fp32 convolutions in TF32
by default.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.runtime import resolve_impl
from ..kernels.ssd_scan import ssd_intra_chunk
from ..parallel.partition import model_axis_dim
from .config import ModelConfig
from .layers import apply_norm, dense, dtype_of, init_dense, init_norm, \
    truncated_normal

__all__ = ["init_mamba2", "apply_mamba2", "mamba2_decode_step",
           "init_ssm_cache", "ssd_chunked", "ssm_head_split",
           "split_mamba2", "apply_mamba2_tp"]


def init_mamba2(generator: torch.Generator, cfg: ModelConfig,
                device) -> dict:
    """The reference's parameters and init scales, drawn from
    ``generator`` (which must live on ``device``)."""
    d, di = cfg.d_model, cfg.ssm_d_inner
    N, H = cfg.ssm_state, cfg.ssm_n_heads
    conv_dim = di + 2 * N               # x + B + C go through the causal conv
    pdt = dtype_of(cfg.param_dtype)
    u = torch.rand((H,), generator=generator, device=device)
    log_dt = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
    return {
        # in_proj: d -> [z, xBC, dt]
        "in_proj": init_dense(generator, d, 2 * di + 2 * N + H, cfg, device),
        "conv_w": truncated_normal(generator, (cfg.ssm_conv, conv_dim),
                                   1.0 / math.sqrt(cfg.ssm_conv), pdt,
                                   device),
        "conv_b": torch.zeros((conv_dim,), dtype=pdt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)
                           ).to(pdt),
        "D": torch.ones((H,), dtype=pdt, device=device),
        # inverse softplus of dt drawn log-uniform in [1e-3, 1e-1]
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))).to(pdt),
        "norm": init_norm(cfg, device, di),
        "out_proj": init_dense(generator, di, d, cfg, device,
                               scale=1.0 / math.sqrt(di)),
    }


def ssd_chunked(xh, dt, A, Bm, Cm, *, chunk: int, initial_state=None,
                impl: str = "auto"):
    """Chunked SSD core.

    xh: (B, S, H, P) per-head inputs; dt: (B, S, H) softplus'd step sizes;
    A: (H,) negative decay rates; Bm/Cm: (B, S, N) input/output projections
    (one group, shared by the heads).  ``initial_state``: (B, H, P, N),
    zeros when None.  Returns ``(y (B, S, H, P) in xh's dtype,
    final_state (B, H, P, N) fp32)``.
    ``impl``: ``auto`` (the kernel on CUDA tensors, the einsum form on the
    CPU), ``kernel`` or ``ref`` (the einsum form)."""
    impl = resolve_impl(impl, xh.device)
    B_, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        # pad to a chunk multiple with dt=0 steps (decay=1, zero input:
        # the recurrent state passes through padding unchanged)
        pad = Q - S % Q
        y, state = ssd_chunked(
            F.pad(xh, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A,
            F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad)),
            chunk=Q, initial_state=initial_state, impl=impl)
        return y[:, :S], state
    nc = S // Q

    xf = xh.float()
    dtf = dt.float()
    Bf = Bm.float()
    Cf = Cm.float()

    # per-step log decay  a[t] = A * dt[t]  (negative)
    a = dtf * A.float()[None, None, :]                      # (B, S, H)
    xc = xf.reshape(B_, nc, Q, H, P)
    dtc = dtf.reshape(B_, nc, Q, H)
    ac = a.reshape(B_, nc, Q, H)
    Bc = Bf.reshape(B_, nc, Q, N)
    Cc = Cf.reshape(B_, nc, Q, N)

    cum = torch.cumsum(ac, dim=2)                           # (B, nc, Q, H)
    if impl == "kernel":
        # the kernel's (B·nc, H, Q, P) layout as views of this memory (the
        # kernel reads them through their strides); it computes y_intra and
        # the states into (B·nc, Q, H, P) and (B·nc, H, P, N) memory, so
        # the reshapes back are views too
        xk = xc.reshape(B_ * nc, Q, H, P).transpose(1, 2)
        dtk = dtc.reshape(B_ * nc, Q, H).transpose(1, 2)[..., None]
        ak = ac.reshape(B_ * nc, Q, H).transpose(1, 2)[..., None]
        Bk = Bc.reshape(B_ * nc, Q, N)
        Ck = Cc.reshape(B_ * nc, Q, N)
        yk, Sk = ssd_intra_chunk(xk, dtk, ak, Bk, Ck, impl=impl)
        y_intra = yk.transpose(1, 2).reshape(B_, nc, Q, H, P)
        S_chunk = Sk.transpose(2, 3).reshape(B_, nc, H, P, N)
    else:
        # ---- intra-chunk (dual quadratic form) ----------------------------
        # L[t,s] = exp(cum[t] - cum[s]) for s<=t else 0; the exponent is
        # selected to 0 above the diagonal before exp as well, so that exp
        # cannot overflow there and its gradient stays finite (the
        # reference selects after exp only: the same values)
        seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
        tri = torch.ones((Q, Q), dtype=torch.bool,
                         device=xh.device).tril()[None, None, :, :, None]
        zero = torch.zeros((), device=xh.device)
        L = torch.where(tri, torch.exp(torch.where(tri, seg, zero)), zero)
        CB = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)          # (B,nc,Q,Q)
        M = CB[..., None] * L                                 # (B,nc,Q,Q,H)
        y_intra = torch.einsum("bcqsh,bcsh,bcshp->bcqhp", M, dtc, xc)

        # state contribution of chunk c:
        #   sum_s exp(cum_end - cum[s]) dt[s] B[s] x[s]
        decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # (B,nc,Q,H)
        S_chunk = torch.einsum("bcsh,bcsh,bcsn,bcshp->bchpn",
                               decay_to_end, dtc, Bc, xc)     # (B,nc,H,P,N)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B, nc, H)

    # ---- inter-chunk sequential loop over the nc chunks -------------------
    if initial_state is None:
        state = torch.zeros((B_, H, P, N), dtype=torch.float32,
                            device=xh.device)
    else:
        state = initial_state.float()
    before = []
    for c in range(nc):
        before.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S_chunk[:, c]
    s_before = torch.stack(before, dim=1)                     # (B,nc,H,P,N)

    # inter contribution: y[t] += exp(cum[t]) * C[t] · s_before
    y_inter = torch.einsum("bcqh,bcqn,bchpn->bcqhp", torch.exp(cum), Cc,
                           s_before)
    y = (y_intra + y_inter).reshape(B_, S, H, P).to(xh.dtype)
    return y, state


def _causal_conv(x, w, b, hist=None):
    """x: (B, S, C); w: (W, C); causal depthwise conv.  ``hist``:
    (B, W-1, C) left context (a previous chunk's raw-conv tail) instead of
    the default zero padding."""
    W = w.shape[0]
    if hist is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([hist, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    return out + b[None, None, :]


def _mixer_core(cfg: ModelConfig, p: dict, x: torch.Tensor, *, di: int,
                H: int, cache: dict | None, valid_len: int | None,
                impl: str):
    """The Mamba-2 mixer up to its gated norm, for ``H`` heads of
    ``d_inner`` ``di`` (the whole mixer's, or a head shard's: its
    ``in_proj`` columns are laid out ``[z, x, B, C, dt]`` either way).
    Returns ``(y · silu(z) (B, S, di) in the compute dtype, conv tail,
    final SSD state)``."""
    cd = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    N, P, W = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_conv

    proj = dense(p["in_proj"], x, cd)
    z, xBC_raw, dt = torch.split(proj, [di, di + 2 * N, H], dim=-1)
    xBC_f32 = xBC_raw.float()
    if cache is not None:
        # the previous chunk's raw-conv tail is the left context
        hist = cache["conv"].float()                          # (B, W-1, C)
        initial_state = cache["state"]
    else:
        hist = torch.zeros((B, W - 1, xBC_f32.shape[-1]), dtype=torch.float32,
                           device=x.device)
        initial_state = None
    xBC = _causal_conv(xBC_f32, p["conv_w"].float(), p["conv_b"].float(),
                       hist=hist)
    xBC = F.silu(xBC).to(cd)
    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)

    dtf = F.softplus(dt.float() + p["dt_bias"].float())
    if valid_len is not None:
        # padding steps must not touch the state: dt = 0 => decay 1, input 0
        real = torch.arange(S, device=x.device)[None, :, None] < valid_len
        dtf = torch.where(real, dtf, torch.zeros((), device=x.device))
    A = -torch.exp(p["A_log"].float())

    xh = xs.reshape(B, S, H, P)
    y, fstate = ssd_chunked(xh, dtf, A, Bm, Cm, chunk=cfg.ssm_chunk,
                            initial_state=initial_state, impl=impl)
    y = y + xh.float().to(cd) * p["D"].to(cd)[None, None, :, None]
    y = y.reshape(B, S, di)
    # rows of [hist, xBC] run from position -(W-1); the last W-1 real
    # inputs are rows [end, end + W - 1) with end the true length
    end = S if valid_len is None else int(valid_len)
    tail = torch.cat([hist, xBC_f32], dim=1)[:, end:end + W - 1, :]
    return y * F.silu(z), tail, fstate


def apply_mamba2(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                 cache: dict | None = None, valid_len: int | None = None,
                 impl: str = "auto"):
    """Full Mamba-2 mixer over a prompt chunk.  x: (B, S, d).  Returns
    ``(out (B, S, d), cache)``: the decode cache (conv tail + final SSD
    state) a later chunk or decode step continues from.

    ``cache``: continue from a prior chunk's decode cache — the causal conv
    reads the cached ``conv`` tail as left context and the SSD scan starts
    from the cached ``state`` (chunked prefill); None starts from zeros.
    ``valid_len``: positions >= ``valid_len`` are right-padding: their
    ``dt`` is forced to 0 so they decay nothing into the state, and the
    returned conv tail is sliced at the true end.  ``impl`` goes to
    :func:`ssd_chunked`."""
    cd = dtype_of(cfg.compute_dtype)
    g, tail, fstate = _mixer_core(cfg, p, x, di=cfg.ssm_d_inner,
                                  H=cfg.ssm_n_heads, cache=cache,
                                  valid_len=valid_len, impl=impl)
    y = apply_norm(cfg, p["norm"], g)
    out = dense(p["out_proj"], y, cd)
    return out, {"conv": tail, "state": fstate}


def ssm_head_split(cfg: ModelConfig, p: dict, n: int) -> bool:
    """Whether ``n`` tensor-parallel positions split a mixer by head: where
    the ``in_proj`` and ``out_proj`` specs put ``model`` on
    ``ssm_inner``.  A split that the heads do not divide, or a mixer whose
    gated norm is not an RMSNorm, raises instead of running whole."""
    if (model_axis_dim(("mixer", "in_proj", "w"), p["in_proj"]["w"].shape,
                       n) != 1
            or model_axis_dim(("mixer", "out_proj", "w"),
                              p["out_proj"]["w"].shape, n) != 0):
        return False
    if cfg.ssm_n_heads % n or cfg.norm != "rmsnorm":
        raise ValueError(f"{cfg.name}: the specs split the SSM mixer over "
                         f"{n} positions, which do not split its "
                         f"{cfg.ssm_n_heads} heads' {cfg.norm} gated norm")
    return True


def split_mamba2(cfg: ModelConfig, p: dict, n: int, i: int) -> dict:
    """Shard ``i`` of ``n`` of a Mamba-2 mixer, split by head: heads
    ``[i·H/n, (i+1)·H/n)``, their ``z``, ``x`` and ``dt`` columns of the
    fused ``in_proj`` with the ``B`` and ``C`` columns whole (one group,
    read by every head), the matching ``conv_w``/``conv_b`` channels (x,
    then B and C), their ``dt_bias``, ``A_log``, ``D`` and slice of the
    gated norm's scale, and their rows of ``out_proj`` (its bias on shard
    0 alone)."""
    di, N, H = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads
    if H % n or not 0 <= i < n:
        raise ValueError(f"shard {i} of {n} does not split {H} SSM heads")
    ds, hs = di // n, H // n
    z = (i * ds, (i + 1) * ds)
    xc = (di + i * ds, di + (i + 1) * ds)
    bc = (2 * di, 2 * di + 2 * N)
    dt = (2 * di + 2 * N + i * hs, 2 * di + 2 * N + (i + 1) * hs)

    def take(t, spans, dim=-1):
        return torch.cat([t.narrow(dim, a, b - a) for a, b in spans], dim)

    conv = [(xc[0] - di, xc[1] - di), (di, di + 2 * N)]
    heads = slice(i * hs, (i + 1) * hs)
    ip = {"w": take(p["in_proj"]["w"], [z, xc, bc, dt])}
    if "b" in p["in_proj"]:
        ip["b"] = take(p["in_proj"]["b"], [z, xc, bc, dt])
    op = {"w": p["out_proj"]["w"][z[0]:z[1]]}
    if i == 0 and "b" in p["out_proj"]:
        op["b"] = p["out_proj"]["b"]
    return {"in_proj": ip, "conv_w": take(p["conv_w"], conv),
            "conv_b": take(p["conv_b"], conv),
            "A_log": p["A_log"][heads], "D": p["D"][heads],
            "dt_bias": p["dt_bias"][heads],
            "norm": {"scale": p["norm"]["scale"][z[0]:z[1]]},
            "out_proj": op}


def apply_mamba2_tp(cfg: ModelConfig, shards, x: torch.Tensor, *,
                    impl: str = "auto", eps: float = 1e-6):
    """:func:`apply_mamba2` from zeros (the training forward) over
    tensor-parallel head shards: ``shards`` holds ``(params, device)`` of
    each (:func:`split_mamba2`), in shard order.  Each shard runs its
    heads' projection, conv and SSD scan on its device (x moved there).
    The gated RMSNorm normalises over the whole ``d_inner``: each shard's
    Σ y² is added in shard order on x's device, and every shard scales by
    the shared rsqrt and its own slice of the scale (a norm over a shard's
    own heads would be another function).  The partial ``out_proj``
    outputs are summed in shard order there.  Returns ``out`` (no cache:
    nothing continues from a training forward)."""
    if cfg.norm != "rmsnorm":
        raise ValueError(f"{cfg.name}: the head split runs an RMSNorm "
                         f"gated norm, not {cfg.norm}")
    cd = dtype_of(cfg.compute_dtype)
    di, H, n = cfg.ssm_d_inner, cfg.ssm_n_heads, len(shards)
    parts = [(_mixer_core(cfg, p_s, x.to(dev), di=di // n, H=H // n,
                          cache=None, valid_len=None, impl=impl)[0], p_s, dev)
             for p_s, dev in shards]
    ss = None
    for g, _, _ in parts:
        part = g.float().square().sum(dim=-1, keepdim=True).to(x.device)
        ss = part if ss is None else ss + part
    r = torch.rsqrt(ss / di + eps)
    out = None
    for g, p_s, dev in parts:
        y = (g.float() * r.to(dev) * p_s["norm"]["scale"].float()).to(g.dtype)
        part = dense(p_s["out_proj"], y, cd).to(x.device)
        out = part if out is None else out + part
    return out


# ---------------------------------------------------------------------------
# Decode (single-token recurrence)
# ---------------------------------------------------------------------------


def init_ssm_cache(cfg: ModelConfig, batch: int, device) -> dict:
    """Zero decode cache of one SSM layer: the raw-conv tail (B, W-1,
    d_inner + 2N) and the SSD state (B, H, P, N), both fp32."""
    di, N, H = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * N),
                            dtype=torch.float32, device=device),
        "state": torch.zeros((batch, H, cfg.ssm_head_dim, N),
                             dtype=torch.float32, device=device),
    }


def mamba2_decode_step(cfg: ModelConfig, p: dict, x: torch.Tensor,
                       cache: dict):
    """x: (B, 1, d); returns ``(out (B, 1, d), new_cache)`` — a new cache
    dict; the old one is left untouched."""
    cd = dtype_of(cfg.compute_dtype)
    B = x.shape[0]
    di, N, H = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads
    P = cfg.ssm_head_dim

    proj = dense(p["in_proj"], x, cd)[:, 0]                   # (B, ...)
    z, xBC, dt = torch.split(proj, [di, di + 2 * N, H], dim=-1)

    # conv ring buffer: history (B, W-1, C) + current
    full = torch.cat([cache["conv"], xBC.float()[:, None, :]], dim=1)
    w = p["conv_w"].float()
    conv_out = torch.einsum("bwc,wc->bc", full, w) + p["conv_b"].float()
    xBC_t = F.silu(conv_out)
    new_conv = full[:, 1:]

    xs, Bm, Cm = torch.split(xBC_t, [di, N, N], dim=-1)
    dtf = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    xh = xs.reshape(B, H, P)
    decay = torch.exp(dtf * A[None, :])                       # (B, H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dtf, Bm, xh)
    state = cache["state"] * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm, state)
    y = y + xh * p["D"].float()[None, :, None]

    y = y.reshape(B, 1, di).to(cd)
    y = apply_norm(cfg, p["norm"], y * F.silu(z[:, None, :]))
    out = dense(p["out_proj"], y, cd)
    return out, {"conv": new_conv, "state": state}
