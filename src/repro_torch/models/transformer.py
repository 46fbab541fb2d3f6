"""Model composition: the dense GQA decoder family (with gemma3's
``local``/``global`` blocks: sliding-window and full attention), the
mixture-of-experts family (``moe`` blocks: attention + routed experts),
the attention-free Mamba-2 (``ssm``) family, zamba2's hybrid (SSM blocks
with one ``shared`` attention + MLP block re-invoked every k of them) and
whisper's encoder-decoder (``enc`` blocks: non-causal self-attention;
``dec`` blocks: causal self-attention, cross-attention over the encoder
output, MLP) for serving and the full-sequence forward, and the dense
family's loss for training.

Parameters are the JAX package's pytree unstacked: ``{"embed": {"table"},
"layers": [block, ...], "norm_f": {"scale"}}`` with one dict per layer in
the order ``layer_kinds`` gives (the reference stacks each pattern
position's layers on a leading axis for ``lax.scan``, then a tail; here a
plain Python loop runs them).  A dense block is ``{"ln1", "attn", "ln2",
"mlp"}``, a MoE block ``{"ln1", "attn", "ln2", "moe"}``, an SSM block
``{"ln1", "mixer"}``, a decoder block the dense one plus ``{"ln_cross",
"cross"}``.  A hybrid model's ``shared`` positions hold ``{}`` in
``"layers"``, and the one block they all run is ``params["shared"]``.  An
encoder-decoder model adds ``"enc_layers"`` (its encoder blocks, the
reference's ``enc_groups`` unstacked), ``"enc_norm_f"``, and the learned
position tables ``"enc_pos"`` and ``"dec_pos"`` (max_seq, d).

Two serving caches, both with the SSM layers' per-slot state ``"conv"``:
(n_ssm, B, W-1, d_inner + 2N) and ``"state"``: (n_ssm, B, H, P, N), fp32
(SSM state is O(1) per slot and has no pages):

* the dense cache (``init_cache``, the dense ``Engine``): ``"k"``/``"v"``
  (n_attn, B, KV, T, D), one per-slot buffer per attention layer (each
  invocation of a shared block is a layer of its own), and
  ``"len"``, a scalar while the batch is uniform and (B,) once slots
  diverge;
* the paged cache (``init_paged_cache``, ``PagedEngine``): ``"k"``/``"v"``
  (n_attn, P, KV, ps, D), one page pool per layer and per K/V, and
  ``"len"`` (B,) int32.

``cache["k"][i]`` is the i-th attention layer's buffer or pool,
``cache["state"][i]`` the i-th SSM layer's state.  ``decode_step`` runs
the dense cache: S == 1 decodes and S > 1 is a batched prefill from a
fresh cache.

The paged steps (``decode_step`` with ``pages``, ``chunk_prefill_step``)
take the pools apart from the cache, in ``shards``: the tensor-parallel
positions of one data row of the serving mesh (``serve/mesh.py``,
:class:`AttnShard`), each with its heads' attention weights and its own
page pools on its device; ``PagedEngine`` without a mesh runs one shard
that holds every head.  The attention layers run split by head
(``attention_tp``), each shard writing its K/V into its own pools; where
the mesh splits them, ``split`` (:class:`RowSplit`) holds the row's
positions' experts and vocabulary rows, which run the MoE blocks' expert
products and the embedding and logits; the norms, dense MLPs, routers,
shared experts and SSM layers run once, on the device of the cache (the
row's lead), which then holds ``"len"`` and the SSM state alone
(``init_paged_cache(pools=False)``).

An encoder-decoder model's serving steps take the encoder output
(``enc_out``, from :func:`encode`) beside the cache: its cross K/V are
recomputed from it on every step, as in the reference, so its caches
hold the decoder's self-attention K/V only, and it has no paged form.

``forward`` runs the whole sequence with no cache and returns the MoE
blocks' summed auxiliary loss; ``loss_fn`` (the training path) takes
every family, at head dims the flash backward kernel takes
(``check_trainable``).  ``loss_sums`` and
``loss_from_sums`` are its two halves for a batch split over the data
rows of a training mesh (``train/step.py``): each row's forward gives the
sums, ``tp_devices`` (the row's tensor-parallel positions) splitting each
block's self-attention by head and its MLP by ``d_ff``, and, where their
specs put ``model`` on them, its experts, SSM heads and cross-attention
heads, and the embedding and the cross-entropy by ``vocab``
(:func:`_tp_shards`, :func:`_vocab_shards`, :func:`_nll_tp`); one scalar,
the loss of the whole batch, is made of every row's.  ``cfg.remat ==
"full"`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``), so its attention and SSD kernels run twice a
layer; ``"save_dots"`` recomputes it too but keeps its 2-D products
(``SAVE_DOTS_OPS``).

The serving steps UPDATE THE CACHE IN PLACE (buffers, pools, SSM state and
``len``) and return the same dict — the reference returns a new cache.
Every layer reads its own buffer or state before writing it, and layers
never share one, so the result equals the reference's read-all-then-write
order.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                      create_selective_checkpoint_contexts)

from ..kernels.flash_attention.kernel import MAX_D_BWD
from ..kernels.runtime import resolve_impl
from ..parallel.partition import model_axis_dim
from ..tree import tree_leaves, tree_map
from .attention import (attention, attention_tp, gather_pages, init_attention,
                        split_attention)
from .config import ModelConfig
from .layers import (apply_mlp, apply_mlp_tp, apply_norm, cast_weights,
                     dtype_of, embed, embed_tp, init_embedding, init_mlp,
                     init_norm, split_mlp, split_vocab, truncated_normal,
                     unembed, unembed_tp, vocab_split)
from .moe import apply_moe, expert_axis, init_moe, split_experts
from .ssm import (apply_mamba2, apply_mamba2_tp, init_mamba2, init_ssm_cache,
                  mamba2_decode_step, split_mamba2, ssm_head_split)

__all__ = ["LayerPlan", "AttnShard", "RowSplit", "layer_plan", "layer_kinds",
           "init_block", "apply_block", "init_params", "param_count",
           "init_cache", "init_paged_cache", "paged_pools", "decode_step",
           "prefill", "encode", "chunk_prefill_step", "check_supported",
           "check_trainable", "forward", "loss_fn", "loss_sums",
           "loss_from_sums"]

#: block kinds the port runs
PORTED_KINDS = ("dense", "local", "global", "moe", "ssm", "shared", "enc",
                "dec")


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    pattern: tuple[str, ...]
    n_groups: int
    tail: tuple[str, ...]
    enc_pattern: tuple[str, ...] = ()
    enc_groups: int = 0


@dataclasses.dataclass
class AttnShard:
    """One tensor-parallel position of a serving mesh's data row (a
    ``PagedEngine`` without a mesh has one, holding every head): the
    shard's config (its head counts, ``attention.split_attention``), its
    device, its attention weights (one dict an attention layer, in layer
    order; each invocation of a shared block is a layer) and its page pools
    ``k``/``v`` (n_attn, P, KV/n, ps, D), None until allocated."""
    cfg: ModelConfig
    device: torch.device
    attn: list
    k: torch.Tensor | None = None
    v: torch.Tensor | None = None

    def layer(self, i: int) -> tuple:
        """``(cfg, attention weights, device)`` of attention layer ``i``:
        what ``attention_tp`` takes of a shard."""
        return self.cfg, self.attn[i], self.device


@dataclasses.dataclass
class RowSplit:
    """What a serving mesh row's tensor-parallel positions hold beside
    the attention shards: ``experts`` maps a MoE layer's index (in layer
    order) to its expert shards ``(axis, [(expert tensors, device),
    ...])`` (``moe.split_experts``), and ``vocab`` holds the embedding's
    shards ``[(rows, lo, device), ...]`` (``layers.split_vocab``), None
    where the vocabulary is whole on the row's lead."""
    experts: dict = dataclasses.field(default_factory=dict)
    vocab: list | None = None


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
    """Raise ``NotImplementedError`` for a block kind the port does not
    run; it runs every kind of the reference's ``layer_plan``."""
    plan = layer_plan(cfg)
    missing = sorted(set(plan.pattern + plan.tail + plan.enc_pattern)
                     - set(PORTED_KINDS))
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
    p = {"ln1": init_norm(cfg, device),
         "attn": init_attention(generator, cfg, device),
         "ln2": init_norm(cfg, device)}
    if kind == "moe":
        p["moe"] = init_moe(generator, cfg, device)
    else:
        p["mlp"] = init_mlp(generator, cfg, device)
    if kind == "dec":
        p["ln_cross"] = init_norm(cfg, device)
        p["cross"] = init_attention(generator, cfg, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device, *, cast: bool = False) -> dict:
    """Random parameters in the port's layout, with the reference's
    truncated-normal scales, drawn from ``generator`` (which must live on
    ``device``).  The numbers differ from the reference's JAX PRNG stream;
    parity tests carry JAX weights over with ``weights.from_jax_numpy``.
    A hybrid model's shared block is drawn once, as ``params["shared"]``;
    its positions in ``"layers"`` hold ``{}``.  An encoder-decoder model's
    encoder blocks, final encoder norm and position tables (std 0.02, as
    the reference draws them) follow.

    ``cast=True`` passes each block through :func:`cast_weights` as soon as
    it is drawn: the values the engines would cast the whole tree to, with
    one ``param_dtype`` block at a time beside the cast copy (a serving
    model's fp32 weights and their bf16 copy need not fit together)."""
    check_supported(cfg)
    kinds = layer_kinds(cfg)
    done = ((lambda p: cast_weights(p, dtype_of(cfg.compute_dtype)))
            if cast else (lambda p: p))
    params = {"embed": done(init_embedding(generator, cfg, device)),
              "layers": [{} if kind == "shared"
                         else done(init_block(generator, cfg, device, kind))
                         for kind in kinds],
              "norm_f": init_norm(cfg, device)}
    if "shared" in kinds:
        params["shared"] = done(init_block(generator, cfg, device, "shared"))
    if cfg.family == "encdec":
        plan = layer_plan(cfg)
        params["enc_layers"] = [
            done(init_block(generator, cfg, device, kind))
            for kind in plan.enc_pattern * plan.enc_groups]
        params["enc_norm_f"] = init_norm(cfg, device)
        dt = dtype_of(cfg.param_dtype)
        for key in ("enc_pos", "dec_pos"):
            params[key] = truncated_normal(generator, (cfg.max_seq,
                                                       cfg.d_model),
                                           0.02, dt, device)
    return params


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def _blocks(cfg: ModelConfig, params: dict):
    """``(kind, block params)`` of every layer in order; a ``shared``
    position runs ``params["shared"]``."""
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        yield kind, (params["shared"] if kind == "shared" else p)


def _window_for(cfg: ModelConfig, kind: str) -> int | None:
    """The attention window of a block kind: ``local_window`` for gemma3's
    local blocks, ``sliding_window`` for dense and MoE blocks (mixtral),
    none for the global, shared, encoder and decoder blocks."""
    if kind == "local":
        return cfg.local_window
    return cfg.sliding_window if kind in ("dense", "moe") else None


def apply_block(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, *,
                positions, cache: dict | None, cache_len,
                paged_impl: str = "auto", impl: str = "auto",
                valid_len: int | None = None, chunk_continue: bool = False,
                enc_out: torch.Tensor | None = None, tp=None,
                mlp_tp=None, moe_tp=None, ssm_tp=None, cross_tp=None,
                moe_sums: bool = False):
    """One pre-norm residual block.  Returns ``(x, update, aux)``: ``aux``
    is a MoE block's load-balancing loss (an fp32 scalar) and None for the
    other kinds.

    The attention kinds (dense, local, global, moe, shared, enc, dec: an
    attention + gated MLP or experts) give the block's K/V delta ``(kt,
    vt)`` as ``update``; ``enc`` attends without a causal mask and with no
    RoPE, ``dec`` with no RoPE and then, given ``enc_out``, over the
    encoder output (cross-attention, ``impl`` picking its core); with
    ``cache=None`` (the full-sequence forward) the update is None and
    ``impl`` picks the attention core.  ``ssm`` gives the slot rows' new
    ``{"conv", "state"}``: one token per row against a cache runs the
    decode recurrence; a longer chunk runs the conv and SSD scan,
    continuing from ``cache`` under ``chunk_continue`` (chunked prefill)
    and from zeros otherwise (the dense engine's batched prefill and the
    forward), with positions >= ``valid_len`` masked out of the state, and
    ``impl`` picks its intra-chunk path.  ``chunk_continue`` likewise tells
    an attention block's S > 1 chunk from a batched prefill.

    ``tp`` (a list of each tensor-parallel shard's ``(cfg, attention
    weights, device)``) runs the block's self-attention split by head
    through ``attention_tp``: ``cache`` is then a list of each shard's
    cache (None for the cache-less form), and ``update`` the list of each
    shard's K/V delta.  ``mlp_tp`` (each shard's ``(MLP weights,
    device)``) runs its MLP split by ``d_ff`` (``apply_mlp_tp``);
    ``moe_tp`` a MoE block's expert products (``apply_moe``'s ``tp``);
    ``ssm_tp`` (each shard's ``(mixer weights, device)``) an SSM block's
    mixer by head (``apply_mamba2_tp``: the cache-less forward, no cache
    update); ``cross_tp`` (as ``tp``) a decoder block's cross-attention
    by head.  ``moe_sums`` gives a MoE block's ``aux`` as ``apply_moe``'s
    sums."""
    if kind == "ssm":
        h = apply_norm(cfg, p["ln1"], x)
        if ssm_tp is not None:
            if cache is not None:
                raise ValueError("the SSM head split runs the cache-less "
                                 "forward")
            return x + apply_mamba2_tp(cfg, ssm_tp, h, impl=impl), None, None
        if cache is not None and x.shape[1] == 1:
            out, new_cache = mamba2_decode_step(cfg, p["mixer"], h, cache)
        else:
            out, new_cache = apply_mamba2(
                cfg, p["mixer"], h, cache=cache if chunk_continue else None,
                valid_len=valid_len, impl=impl)
        return x + out, new_cache, None
    h = apply_norm(cfg, p["ln1"], x)
    kw = dict(positions=positions, cache_len=cache_len,
              window=_window_for(cfg, kind), paged_impl=paged_impl,
              impl=impl, chunk_continue=chunk_continue, causal=kind != "enc",
              rope=cfg.use_rope and kind not in ("enc", "dec"))
    if tp is None:
        out, kv = attention(cfg, p["attn"], h, cache=cache, **kw)
    else:
        out, kv = attention_tp(tp, h, caches=[None] * len(tp)
                               if cache is None else cache, **kw)
    x = x + out
    if kind == "dec" and enc_out is not None:
        h = apply_norm(cfg, p["ln_cross"], x)
        ckw = dict(positions=positions, kv_x=enc_out, causal=False,
                   rope=False, impl=impl)
        if cross_tp is None:
            out, _ = attention(cfg, p["cross"], h, cache=None, **ckw)
        else:
            out, _ = attention_tp(cross_tp, h,
                                  caches=[None] * len(cross_tp), **ckw)
        x = x + out
    h = apply_norm(cfg, p["ln2"], x)
    aux = None
    if kind == "moe":
        out, aux = apply_moe(cfg, p["moe"], h, sums=moe_sums, tp=moe_tp)
    elif mlp_tp is not None:
        out = apply_mlp_tp(cfg, mlp_tp, h)
    else:
        out = apply_mlp(cfg, p["mlp"], h)
    return x + out, kv, aux


# ---------------------------------------------------------------------------
# Full-sequence forward and loss (training)
# ---------------------------------------------------------------------------


REMATS = ("none", "full", "save_dots")

#: the products ``save_dots`` keeps from the forward: a 2-D product with no
#: batch dimension (the ``x @ w`` projections fold to ``mm``, a biased one
#: to ``addmm``), as ``jax.checkpoint_policies.
#: dots_with_no_batch_dims_saveable`` keeps the reference's dots with no
#: batch dims; ``bmm`` (the attention, SSD and expert einsums), the kernels
#: and every other op are recomputed
SAVE_DOTS_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _check_remat(cfg: ModelConfig) -> None:
    if cfg.remat not in REMATS:
        raise NotImplementedError(f"remat={cfg.remat!r} is not ported (the "
                                  f"port runs {REMATS})")


def _save_dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in SAVE_DOTS_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_dots_contexts():
    return create_selective_checkpoint_contexts(_save_dots_policy)


def check_trainable(cfg: ModelConfig) -> None:
    """The training entry points (``loss_fn``, the fused step, the HyPar
    trainer) take every block kind and every remat policy, at head dims
    the flash backward kernel takes (up to ``MAX_D_BWD``, 256: every
    configuration of the repo, gemma3-4b's 256 the widest).  A wider head
    dim is refused up front, so a step never fails halfway through on the
    card.  An attention-free model (mamba2) has no head dim to check."""
    check_supported(cfg)
    has_attn = any(k != "ssm" for k in layer_kinds(cfg))
    if has_attn and cfg.hd > MAX_D_BWD:
        raise NotImplementedError(
            f"{cfg.name}: head dim {cfg.hd} is wider than the flash "
            f"backward kernel's {MAX_D_BWD}")
    _check_remat(cfg)


def _placed(tree, dev):
    return tree_map(lambda t: t.to(dev), tree)


def _heads_split(cfg: ModelConfig, n: int) -> bool:
    return not (cfg.n_heads % n or cfg.n_kv_heads % n)


def _tp_shards(cfg: ModelConfig, p: dict, devices) -> dict:
    """A block split over a data row's tensor-parallel positions
    ``devices`` (training's TP), as :func:`apply_block`'s keywords: its
    self-attention by head (``tp``) and MLP by ``d_ff`` (``mlp_tp``) where
    ``len(devices)`` divides the heads and ``d_ff``, as the serving mesh
    splits them; and, where the leaves' specs put ``model`` on their axis
    (``partition.model_axis_dim``), its experts by ``experts`` or ``d_ff``
    (``moe_tp``), its SSM mixer by head (``ssm_tp``, on ``ssm_inner``) and
    its cross-attention by head (``cross_tp``, on ``heads_flat``, where the
    heads divide too).  A part left out runs whole on the row's lead.  The
    shards are copies (``.to`` their device, the split's own copies),
    built inside the block so that a recompute rebuilds them instead of
    keeping them; a shard on the lead's device is not moved."""
    n = len(devices) if devices else 1
    out: dict = {}
    if n == 1:
        return out
    if "attn" in p and _heads_split(cfg, n):
        out["tp"] = []
        for i, dev in enumerate(devices):
            cfg_s, p_s = split_attention(cfg, p["attn"], n, i)
            out["tp"].append((cfg_s, _placed(p_s, dev), dev))
    if "mlp" in p and not p["mlp"]["up"]["w"].shape[1] % n:
        out["mlp_tp"] = [(_placed(split_mlp(p["mlp"], n, i), dev), dev)
                         for i, dev in enumerate(devices)]
    if "moe" in p:
        axis = expert_axis(p["moe"], n)
        if axis is not None:
            out["moe_tp"] = (axis, [
                (_placed(split_experts(p["moe"], n, i, axis), dev), dev)
                for i, dev in enumerate(devices)])
    if "mixer" in p and ssm_head_split(cfg, p["mixer"], n):
        out["ssm_tp"] = [(_placed(split_mamba2(cfg, p["mixer"], n, i), dev),
                          dev) for i, dev in enumerate(devices)]
    if ("cross" in p and _heads_split(cfg, n)
            and model_axis_dim(("cross", "q", "w"),
                               p["cross"]["q"]["w"].shape, n) == 1):
        out["cross_tp"] = []
        for i, dev in enumerate(devices):
            cfg_s, p_s = split_attention(cfg, p["cross"], n, i)
            out["cross_tp"].append((cfg_s, _placed(p_s, dev), dev))
    return out


def _vocab_shards(p: dict, devices) -> list | None:
    """The embedding split by ``vocab`` over a row's tensor-parallel
    positions ``devices``, ``[(rows, lo, device), ...]`` for
    :func:`~repro_torch.models.layers.embed_tp`/``unembed_tp``, where the
    table's spec puts ``model`` on ``vocab``; None where it stays whole."""
    n = len(devices) if devices else 1
    if not vocab_split(p, n):
        return None
    return [(_placed(rows, dev), lo, dev)
            for i, dev in enumerate(devices)
            for rows, lo in [split_vocab(p, n, i)]]


def _embed(cfg: ModelConfig, params: dict, tokens, vocab):
    if vocab is None:
        return embed(cfg, params["embed"], tokens)
    return embed_tp(cfg, vocab, tokens)


def _logits(cfg: ModelConfig, params: dict, x, vocab):
    """The logits over the whole vocabulary on x's device: one product, or
    the vocab shards' slices concatenated in order."""
    if vocab is None:
        return unembed(cfg, params["embed"], x)
    return torch.cat([part.to(x.device)
                      for part in unembed_tp(cfg, vocab, x)], dim=-1)


def _run_stack(cfg: ModelConfig, blocks, x, positions, *, impl: str,
               enc_out=None, tp_devices=None, moe_sums: bool = False):
    """Every ``(kind, params)`` of ``blocks`` in order.  Under grad, each
    block is recomputed in the backward pass under ``remat="full"``, and
    recomputed but for its 2-D products (:data:`SAVE_DOTS_OPS`) under
    ``remat="save_dots"``.  Returns ``(x, aux)``: the MoE blocks' summed
    auxiliary loss (0 for the other families), or under ``moe_sums`` the
    list of each MoE block's sums.  ``tp_devices`` splits each block over
    those positions (:func:`_tp_shards`)."""
    aux = ([] if moe_sums
           else torch.zeros((), dtype=torch.float32, device=x.device))
    remat = cfg.remat if torch.is_grad_enabled() else "none"
    for kind, p in blocks:
        def block(h, p=p, kind=kind):
            return apply_block(cfg, kind, p, h, positions=positions,
                               cache=None, cache_len=None, impl=impl,
                               enc_out=enc_out, moe_sums=moe_sums,
                               **_tp_shards(cfg, p, tp_devices))
        if remat == "full":
            x, _, a = checkpoint(block, x, use_reentrant=False)
        elif remat == "save_dots":
            x, _, a = checkpoint(block, x, use_reentrant=False,
                                 context_fn=_save_dots_contexts)
        else:
            x, _, a = block(x)
        if a is None:
            continue
        if moe_sums:
            aux.append(a)
        else:
            aux = aux + a
    return x, aux


def encode(cfg: ModelConfig, params: dict, enc_embeds: torch.Tensor, *,
           impl: str = "auto", tp_devices=None) -> torch.Tensor:
    """An encoder-decoder model's encoder: ``enc_embeds`` (B, T, d) plus
    ``enc_pos[:T]`` through the encoder blocks (non-causal, ``impl``
    picking their attention core) and the final encoder norm.  Returns
    ``enc_out`` (B, T, d) in the compute dtype."""
    plan = layer_plan(cfg)
    e = enc_embeds.to(dtype_of(cfg.compute_dtype))
    e = e + params["enc_pos"][:e.shape[1]].to(e.dtype)[None]
    kinds = plan.enc_pattern * plan.enc_groups
    e, _ = _run_stack(cfg, zip(kinds, params["enc_layers"]), e,
                      torch.arange(e.shape[1], device=e.device), impl=impl,
                      tp_devices=tp_devices)
    return apply_norm(cfg, params["enc_norm_f"], e)


def _add_dec_pos(cfg: ModelConfig, params: dict, x, positions):
    """The decoder's learned positions, ``dec_pos[positions]``, added to
    an encoder-decoder model's token embeddings (others pass through)."""
    if cfg.family != "encdec":
        return x
    pe = params["dec_pos"][positions.long()]
    return x + (pe if positions.dim() > 1 else pe[None]).to(x.dtype)


def forward(cfg: ModelConfig, params: dict, *, tokens=None, embeds=None,
            positions=None, enc_embeds=None, impl: str = "auto",
            tp_devices=None, moe_sums: bool = False):
    """Full-sequence forward (train / prefill).  ``tokens`` (B, S) int, or
    ``embeds`` (B, S, d); an encoder-decoder model also takes
    ``enc_embeds`` (B, T, d), its encoder input.  Returns ``(logits (B, S,
    padded_vocab) in the compute dtype, aux)``, aux the MoE blocks' summed
    load-balancing loss; ``impl`` picks every layer's attention core (and
    the SSM layers' intra-chunk path).  ``tp_devices`` and ``moe_sums`` as
    in :func:`_run_stack` (under ``moe_sums``, aux is the list of each MoE
    block's sums); ``tp_devices`` also splits the embedding and the
    logits by ``vocab`` (:func:`_vocab_shards`), whose slices are then
    concatenated on the lead."""
    vocab = _vocab_shards(params["embed"], tp_devices)
    x, aux = _trunk(cfg, params, tokens=tokens, embeds=embeds,
                    positions=positions, enc_embeds=enc_embeds, impl=impl,
                    tp_devices=tp_devices, moe_sums=moe_sums, vocab=vocab)
    return _logits(cfg, params, x, vocab), aux


def _trunk(cfg: ModelConfig, params: dict, *, tokens, embeds, positions,
           enc_embeds, impl: str, tp_devices, moe_sums: bool, vocab):
    """:func:`forward` up to the final norm: ``(x (B, S, d), aux)``."""
    check_supported(cfg)
    _check_remat(cfg)
    if embeds is None:
        x = _embed(cfg, params, tokens, vocab)
    else:
        x = embeds.to(dtype_of(cfg.compute_dtype))
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    enc_out = None
    if cfg.family == "encdec":
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder model needs "
                             f"enc_embeds")
        enc_out = encode(cfg, params, enc_embeds, impl=impl,
                         tp_devices=tp_devices)
        x = _add_dec_pos(cfg, params, x, positions)
    x, aux = _run_stack(cfg, _blocks(cfg, params), x, positions, impl=impl,
                        enc_out=enc_out, tp_devices=tp_devices,
                        moe_sums=moe_sums)
    return apply_norm(cfg, params["norm_f"], x), aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            impl: str = "auto"):
    """Next-token cross-entropy: the mask-weighted mean NLL over
    ``batch["tokens"]`` / ``"labels"`` / ``"mask"`` (optional), with the
    padded vocabulary masked out of the softmax.  Returns ``(total,
    {"loss", "aux", "tokens"})``: ``total`` adds ``router_aux_weight``
    times the MoE blocks' auxiliary loss.  An encoder-decoder model reads
    its encoder input from ``batch["enc_embeds"]``.  A training entry
    point (:func:`check_trainable`)."""
    check_trainable(cfg)
    logits, aux = forward(cfg, params, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"),
                          enc_embeds=batch.get("enc_embeds"), impl=impl)
    nll = _nll(cfg, logits, batch["labels"])
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.float()
    loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    total = loss + cfg.router_aux_weight * aux
    return total, {"loss": loss, "aux": aux, "tokens": mask.sum()}


def _nll(cfg: ModelConfig, logits: torch.Tensor, labels) -> torch.Tensor:
    """Each token's negative log-likelihood in fp32, the padded vocabulary
    masked out of the softmax."""
    logits = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e9
    logz = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    return logz - logits.gather(-1, labels[..., None])[..., 0]


def _nll_tp(cfg: ModelConfig, vocab: list, x: torch.Tensor,
            labels) -> torch.Tensor:
    """:func:`_nll` over vocab shards, each token's on x's device: every
    shard makes its logits slice (the padded vocabulary masked by global
    index on the shard that holds it), its max mᵢ and its sum sᵢ of
    exp(logit − mᵢ), and the logit of the labels it holds (0 for the
    others); logz = m + log Σᵢ sᵢ·exp(mᵢ − m) and the label's logit are
    added up in shard order.  The maxes are constants to the gradient, as
    in a log-sum-exp."""
    stats = []
    for logits, (_, lo, dev) in zip(unembed_tp(cfg, vocab, x), vocab):
        lf = logits.float()
        n = lf.shape[-1]
        if lo + n > cfg.vocab_size:
            lf[..., max(cfg.vocab_size - lo, 0):] = -1e9
        m = lf.detach().amax(dim=-1)
        s = torch.exp(lf - m[..., None]).sum(dim=-1)
        lab = labels.to(dev).long() - lo
        inside = (lab >= 0) & (lab < n)
        picked = lf.gather(-1, lab.clamp(0, n - 1)[..., None])[..., 0]
        ll = torch.where(inside, picked, torch.zeros((), device=dev))
        stats.append((m.to(x.device), s.to(x.device), ll.to(x.device)))
    m = stats[0][0]
    for mi, _, _ in stats[1:]:
        m = torch.maximum(m, mi)
    total = ll = None
    for mi, si, li in stats:
        t = si * torch.exp(mi - m)
        total = t if total is None else total + t
        ll = li if ll is None else ll + li
    return m + torch.log(total) - ll


def loss_sums(cfg: ModelConfig, params: dict, batch: dict, *,
              impl: str = "auto", tp_devices=None) -> dict:
    """One data row's share of :func:`loss_fn`'s loss for its slice of the
    batch: ``{"nll": Σ nll·mask, "mask": Σ mask, "n": the slice's tokens,
    "moe": each MoE block's (Σ router probs, Σ top-1 one-hots)}``, what
    adds up over the rows (:func:`loss_from_sums`).  ``tp_devices``: the
    row's tensor-parallel positions, the lead first (where ``params``
    live); where they split the vocabulary, the NLL comes from the vocab
    shards' log-sum-exp (:func:`_nll_tp`) and no position makes the whole
    vocabulary's logits."""
    check_trainable(cfg)
    vocab = _vocab_shards(params["embed"], tp_devices)
    x, moe = _trunk(cfg, params, tokens=batch.get("tokens"),
                    embeds=batch.get("embeds"), positions=None,
                    enc_embeds=batch.get("enc_embeds"), impl=impl,
                    tp_devices=tp_devices, moe_sums=True, vocab=vocab)
    if vocab is None:
        nll = _nll(cfg, unembed(cfg, params["embed"], x), batch["labels"])
    else:
        nll = _nll_tp(cfg, vocab, x, batch["labels"])
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.float()
    return {"nll": (nll * mask).sum(), "mask": mask.sum(),
            "n": nll.numel(), "moe": moe}


def loss_from_sums(cfg: ModelConfig, rows: list[dict], device):
    """:func:`loss_fn`'s ``(total, metrics)`` of a batch split over data
    rows, from each row's :func:`loss_sums`, added on ``device`` in row
    order: the masked NLL sum over the whole mask sum, and each MoE block's
    load-balancing loss ``E · Σ me·ce`` from the probabilities and top-1
    one-hots averaged over every row's tokens (a mean of the rows' own
    means would be another loss)."""
    def total_of(values):
        out = None
        for v in values:
            v = v.to(device)
            out = v if out is None else out + v
        return out

    nll = total_of(r["nll"] for r in rows)
    mask = total_of(r["mask"] for r in rows)
    loss = nll / mask.clamp_min(1.0)
    aux = torch.zeros((), dtype=torch.float32, device=device)
    n = sum(r["n"] for r in rows)
    for layer in zip(*(r["moe"] for r in rows)):
        me = total_of(probs for probs, _ in layer) / n
        ce = total_of(top1 for _, top1 in layer) / n
        aux = aux + cfg.n_experts * (me * ce).sum()
    total = loss + cfg.router_aux_weight * aux
    return total, {"loss": loss, "aux": aux, "tokens": mask}


# ---------------------------------------------------------------------------
# Serving caches and steps
# ---------------------------------------------------------------------------


def _new_cache(cfg: ModelConfig, batch: int, lens: torch.Tensor,
               kv_rows: int, kv_cols: int, device, *,
               kv: bool = True) -> dict:
    """``{"len": lens}`` plus zero K/V of shape (n_attn, kv_rows, KV,
    kv_cols, D) for the attention layers and zero per-slot SSM state for
    the SSM layers, each stacked on a leading layer axis.  Every
    invocation of a shared block is an attention layer of its own, with
    its own K/V (the reference stacks them over its groups)."""
    check_supported(cfg)
    n_ssm = layer_kinds(cfg).count("ssm")
    cache = {"len": lens}
    if kv:
        cache.update(_kv_buffers(cfg, kv_rows, kv_cols, device))
    if n_ssm:
        for key, t in init_ssm_cache(cfg, batch, device).items():
            cache[key] = t[None].repeat((n_ssm,) + (1,) * t.dim())
    return cache


def _kv_buffers(cfg: ModelConfig, kv_rows: int, kv_cols: int,
                device) -> dict:
    """Zero ``"k"``/``"v"`` (n_attn, kv_rows, KV, kv_cols, D), KV
    ``cfg.n_kv_heads``; none for an attention-free model."""
    kinds = layer_kinds(cfg)
    n_attn = len(kinds) - kinds.count("ssm")
    if not n_attn:
        return {}
    dt = dtype_of(cfg.kv_cache_dtype or cfg.compute_dtype)
    shape = (n_attn, kv_rows, cfg.n_kv_heads, kv_cols, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def paged_pools(cfg: ModelConfig, *, num_pages: int, page_size: int,
                device) -> dict:
    """The paged cache's zero page pools alone, ``{"k", "v"}`` (n_attn, P,
    KV, page_size, D) with KV ``cfg.n_kv_heads`` (a tensor-parallel
    shard's config gives its own); empty for an attention-free model."""
    return _kv_buffers(cfg, num_pages, page_size, device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device) -> dict:
    """Dense serving cache: per-slot K/V buffers (B, KV, max_len, D) per
    attention layer, per-slot SSM state per SSM layer, and a scalar
    ``len`` of 0 (the dense engine broadcasts it to (B,) after a
    prefill).  An encoder-decoder cache holds the decoder's self-attention
    K/V only: cross K/V are recomputed from the encoder output."""
    return _new_cache(cfg, batch,
                      torch.zeros((), dtype=torch.int32, device=device),
                      batch, max_len, device)


def init_paged_cache(cfg: ModelConfig, batch: int, *, num_pages: int,
                     page_size: int, device, pools: bool = True) -> dict:
    """Paged serving cache: one shared page pool (P, KV, page_size, D) per
    attention layer and per K/V, stacked on a leading layer axis; dense
    per-slot conv tail and SSD state per SSM layer, stacked likewise; and
    per-slot lengths.  An attention-free model gets no pool, and neither
    does ``pools=False`` (a serving mesh's row, whose pools its
    tensor-parallel shards hold: :func:`paged_pools`).  Page 0 is the
    trash page.  Encoder-decoder models are refused, as in the
    reference."""
    if cfg.family == "encdec":
        raise NotImplementedError("paged KV for encdec (cross-attention "
                                  "buffers) is not implemented")
    return _new_cache(cfg, batch,
                      torch.zeros((batch,), dtype=torch.int32, device=device),
                      num_pages, page_size, device, kv=pools)


def _write_kv(buf, delta, pos) -> None:
    """Write a step's K/V delta (B, KV, S, D) into one layer's dense
    buffer (B, KV, T, D), in place, at the token position: ``pos`` a
    scalar (one slice for the whole batch) or (B,) (one position a slot,
    S == 1).  A write that would run past the buffer lands at its end, as
    the reference's ``dynamic_update_slice`` clamps its start index: a
    free slot's ``len`` keeps growing with every decode step and passes
    ``max_len``, and its writes then overwrite position T - 1, which
    nothing reads as valid."""
    T, S = buf.shape[2], delta.shape[2]
    if S > T:
        raise ValueError(f"{S} positions do not fit a cache of {T}")
    if pos.dim() == 0:
        start = min(max(int(pos), 0), T - S)
        buf[:, :, start:start + S] = delta.to(buf.dtype)
        return
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, :, pos.long().clamp(0, T - 1)] = delta[:, :, 0].to(buf.dtype)


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


def _check_shards(cfg: ModelConfig, shards) -> None:
    """A paged step of a model with attention layers needs the shards that
    hold their pools."""
    if not shards and any(k != "ssm" for k in layer_kinds(cfg)):
        raise ValueError("a paged step reads the attention pools from its "
                         "shards (AttnShard): pass shards")


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, *, pages: torch.Tensor | None = None,
                page_size: int | None = None, paged_impl: str = "auto",
                update_mask=None, impl: str = "auto",
                valid_len: int | None = None,
                enc_out: torch.Tensor | None = None,
                shards: Sequence[AttnShard] = (),
                split: RowSplit | None = None):
    """One cache-extending step for every slot.  tokens: (B, S) int.

    Dense cache (``pages=None``): S == 1 decodes against the per-slot
    buffers (``len`` a scalar or (B,)); S > 1 is a batched prefill from a
    fresh cache (scalar ``len``; a (B,) ``len`` is refused, as in the
    reference), whose attention reads no cache (``impl`` picks its core:
    the flash kernel on CUDA under ``auto``) and whose SSM layers scan from
    zeros with positions >= ``valid_len`` (a right-padded prompt's true
    length) masked out of the state.

    Paged cache: ``pages`` (B, n_pages) int32 page table on the cache's
    device, S == 1, and ``shards``, the tensor-parallel shards that hold
    the attention layers' weights and page pools (see the module
    docstring; one shard holds every head), each of which gets ``pages``
    on its device.  Every slot, free ones included, reads its pages,
    writes its token's K/V through the table and has its ``len`` bumped —
    free slots' rows point at the trash page.  ``paged_impl``: ``auto``
    (the kernel on a CUDA cache, the gather oracle on the CPU), ``kernel``
    or ``ref`` (gather ``gather_pages`` view + ``_decode_attn_plus_self``).

    ``update_mask`` (B,) bool: freeze the per-slot SSM state of masked-out
    slots (mid-prefill slots between their chunks); None advances every
    slot.  An encoder-decoder model adds ``dec_pos`` at each slot's
    positions and attends over ``enc_out`` (B, T, d) in every decoder
    block.  ``split`` (a serving mesh row's :class:`RowSplit`) runs the
    MoE blocks' expert products and the embedding and logits over the
    row's positions, the logits' slices concatenated on the lead.
    Updates the cache in place; returns ``(logits (B, S, V), cache)``."""
    split = split or RowSplit()
    x = _embed(cfg, params, tokens, split.vocab)
    S = x.shape[1]
    pos = cache["len"]
    if pages is not None and S != 1:
        raise ValueError("a paged decode_step takes one token per slot "
                         "(S == 1)")
    if pages is not None:
        _check_shards(cfg, shards)
    elif shards:
        raise ValueError("tensor-parallel shards hold page pools: pass "
                         "pages")
    # ``len`` may be a scalar (uniform batch) or (B,) (per-slot lengths
    # under continuous batching); vector lengths are decode-only
    if pos.dim() == 1 and S > 1:
        raise ValueError("per-slot cache lengths only support single-token "
                         "decode (S == 1); prefill from a fresh cache")
    steps = torch.arange(S, device=x.device)
    positions = pos[:, None] + steps if pos.dim() == 1 else pos + steps
    x = _add_dec_pos(cfg, params, x, positions)
    if pages is not None:
        paged_impl = resolve_impl(paged_impl, pos.device)
        shard_io = [(pages.to(sh.device), pos.to(sh.device))
                    for sh in shards]
    ai = si = 0
    for li, (kind, p) in enumerate(_blocks(cfg, params)):
        if kind == "ssm":
            lc = {"conv": cache["conv"][si], "state": cache["state"][si]}
            x, new, _ = apply_block(cfg, kind, p, x, positions=positions,
                                 cache=lc, cache_len=pos, impl=impl,
                                 valid_len=valid_len)
            _write_ssm_state(lc, new, update_mask)
            si += 1
            continue
        if pages is not None:
            lcs = [{"k": gather_pages(sh.k[ai], pg),
                    "v": gather_pages(sh.v[ai], pg)} if paged_impl == "ref"
                   else {"k_pool": sh.k[ai], "v_pool": sh.v[ai], "pages": pg}
                   for sh, (pg, _) in zip(shards, shard_io)]
            x, kvs, _ = apply_block(cfg, kind, p, x, positions=positions,
                                    cache=lcs, cache_len=pos,
                                    paged_impl=paged_impl, impl=impl,
                                    tp=[sh.layer(ai) for sh in shards],
                                    moe_tp=split.experts.get(li))
            for sh, (pg, sp), (kt, vt) in zip(shards, shard_io, kvs):
                _write_kv_paged(sh.k[ai], kt, sp, pg, page_size)
                _write_kv_paged(sh.v[ai], vt, sp, pg, page_size)
            ai += 1
            continue
        kb, vb = cache["k"][ai], cache["v"][ai]
        ai += 1
        x, (kt, vt), _ = apply_block(cfg, kind, p, x, positions=positions,
                                     cache={"k": kb, "v": vb}, cache_len=pos,
                                     impl=impl, enc_out=enc_out,
                                     moe_tp=split.experts.get(li))
        _write_kv(kb, kt, pos)
        _write_kv(vb, vt, pos)
    x = apply_norm(cfg, params["norm_f"], x)
    logits = _logits(cfg, params, x, split.vocab)
    cache["len"] += S
    return logits, cache


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            max_len: int | None = None, impl: str = "auto",
            enc_embeds: torch.Tensor | None = None):
    """The small-scale reference prefill: a fresh dense cache extended one
    token at a time by ``decode_step``.  Returns ``(cache, logits (B, 1,
    V) of the last prompt token, enc_out)``: ``enc_out`` is an
    encoder-decoder model's encoder output (from ``enc_embeds``), None for
    the other families."""
    B, S = tokens.shape
    enc_out = None
    if cfg.family == "encdec":
        enc_out = encode(cfg, params, enc_embeds, impl=impl)
    cache = init_cache(cfg, B, max_len or S + 64, device=tokens.device)
    logits = None
    for t in range(S):
        logits, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1],
                                    impl=impl, enc_out=enc_out)
    return cache, logits, enc_out


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
                       page_size: int, impl: str = "auto",
                       shards: Sequence[AttnShard] = (),
                       split: RowSplit | None = None):
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
    ``len`` becomes ``start + valid_len``.  ``shards``: the
    tensor-parallel shards that hold the attention layers' weights and
    page pools, and ``split``, as in :func:`decode_step`.  Updates the
    cache in place; returns ``(logits (1, 1, V) at the true last chunk
    token, cache)``.  Encoder-decoder models are refused, as in the
    reference."""
    if cfg.family == "encdec":
        raise NotImplementedError("chunked prefill for encdec models")
    _check_shards(cfg, shards)
    split = split or RowSplit()
    x = _embed(cfg, params, tokens, split.vocab)
    C = x.shape[1]
    positions = start + torch.arange(C, device=x.device)
    # pages below ``start`` are all the chunk may read; the reference
    # gathers the whole row and masks positions >= start, which adds only
    # exact zeros
    shard_rows = [pages_row.to(sh.device) for sh in shards]
    ai = si = 0
    for li, (kind, p) in enumerate(_blocks(cfg, params)):
        if kind == "ssm":
            rows = {key: cache[key][si, slot:slot + 1]
                    for key in ("conv", "state")}
            # a first chunk starts from zeros: the slot's rows still hold
            # its previous occupant's state
            lc = (rows if start > 0
                  else {k: torch.zeros_like(t) for k, t in rows.items()})
            x, new, _ = apply_block(cfg, kind, p, x, positions=positions,
                                    cache=lc, cache_len=start, impl=impl,
                                    valid_len=valid_len, chunk_continue=True)
            _write_ssm_state(rows, new, None)
            si += 1
            continue
        lcs = [{"k": gather_pages(sh.k[ai], r[:, :start // page_size]),
                "v": gather_pages(sh.v[ai], r[:, :start // page_size])}
               if start > 0 else {}
               for sh, r in zip(shards, shard_rows)]
        x, kvs, _ = apply_block(cfg, kind, p, x, positions=positions,
                                cache=lcs, cache_len=start,
                                chunk_continue=True,
                                tp=[sh.layer(ai) for sh in shards],
                                moe_tp=split.experts.get(li))
        for sh, r, (kt, vt) in zip(shards, shard_rows, kvs):
            _write_kv_chunk_paged(sh.k[ai], kt, start, r[0], page_size)
            _write_kv_chunk_paged(sh.v[ai], vt, start, r[0], page_size)
        ai += 1
    x = apply_norm(cfg, params["norm_f"], x)
    last = x[:, valid_len - 1:valid_len]
    logits = _logits(cfg, params, last, split.vocab)
    cache["len"][slot] = start + valid_len
    return logits, cache
