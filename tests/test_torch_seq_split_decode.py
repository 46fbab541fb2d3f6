"""Distributed flash-decoding over a dense KV cache split by sequence
(``parallel.partition.place_cache``, ``models.attention.KVBlocks``,
``decode_step`` over the placed cache), against the JAX package.

The reference's sharded decode equals its unsharded one (GSPMD changes no
value), so its plain ``decode_step`` on one device is the yardstick, run
in this process.  The port's seeded weights are handed to it in its own
tree (``weights.from_jax_numpy`` gives them back); the cache is drawn
once with numpy from a seed and handed to both sides (a bf16 or e4m3
cache as its bytes).  Over 3 steps the split port's logits stay
within 1e-5 of the logit scale of the reference's (fp32 compute) and the
caches equal (fp32 and bf16 to 1e-5 of their scale, e4m3 byte for
byte), with the same greedy tokens, on grids that split the sequence 2, 4
and 8 ways, over two axes, by KV head, by slot, and not at all where the
split does not divide T; with whole weights, and with the weights placed
by their ``params`` specs (``place_tree``), each block gathered as it
runs, whose logits meet the reference's at 1e-4 of their scale (the
tensor-parallel sum of partial outputs moves a bf16 cache entry across a
rounding, by one bf16 spacing, 2^-9 of the cache's scale, and the logits
by 3.0e-5 of theirs on llama3 smoke's 2 x 4 grid).  The SSM layers' ``conv`` and ``state`` are placed too, by channel
and head.

The placement is the reference's: every leaf's spec equals its
``_cache_axes`` resolved by its ``rules_for_cell(...).spec_for`` for every
arch × decode cell, the leaves placed on the 16 x 16 grid split into the
reference's shard shapes, and the dry-run's decode cells hold the
``params`` and ``cache`` specs' bytes a position.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch.specs import rules_for_cell as jax_rules_for_cell
from repro.models.attention import decode_attention as jax_decode_attention
from repro.models.config import SHAPE_CELLS as JAX_CELLS
from repro.models.transformer import decode_step as jax_decode_step
from repro.models.transformer import init_cache as jax_init_cache
from repro.models.transformer import init_params as jax_init
from repro.models.transformer import layer_plan as jax_layer_plan
from repro.parallel.partition import _cache_axes as jax_cache_axes
from repro.parallel.sharding import ShardingRules as JaxRules
from repro_torch.configs import ARCHS, cells_for, get_config, get_smoke_config
from repro_torch.launch.mesh import compat_make_mesh, make_production_mesh
from repro_torch.launch.specs import build_cell, rules_for_cell
from repro_torch.models.attention import (NEG_INF, KVBlocks, decode_attention,
                                          decode_attention_split,
                                          decode_partial, merge_partials)
from repro_torch.models.config import SHAPE_CELLS
from repro_torch.models.transformer import decode_step, init_cache
from repro_torch.parallel.partition import (Placed, cache_spec, gather_tree,
                                            place_cache, place_tree,
                                            position_bytes, spec_bytes)
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_jax_numpy, init_params

LOGIT_TOL = 1e-5            # of max|logit|, fp32 compute
PLACED_LOGIT_TOL = 1e-4     # the same, the weights placed by their specs
# a bf16 cache under placed weights: an entry whose fp32 value the
# tensor-parallel sum moved across a bf16 rounding differs by one spacing
PLACED_CACHE_TOL_BF16 = 2.0 ** -8
CACHE_TOL = 1e-5            # of max|cache|, fp32 caches
STEPS = 3
F8 = torch.float8_e4m3fn

#: (arch, config overrides, batch, cache length T, per-slot lengths): the
#: lengths put slots in every block and leave whole blocks masked
CASES = {
    "llama3": ("llama3-405b", {}, 3, 64, (10, 40, 61)),
    "llama3_e4m3": ("llama3-405b", {"kv_cache_dtype": "float8_e4m3fn"}, 3,
                    64, (10, 40, 61)),
    # gemma3's local window of 16 inside one block of 32 (slot 0) and
    # across two (slot 1); its global layers read the whole cache
    "gemma3": ("gemma3-4b", {}, 2, 128, (70, 100)),
    "mixtral": ("mixtral-8x7b", {}, 2, 64, (20, 57)),
    "zamba2": ("zamba2-1.2b", {}, 2, 64, (9, 50)),
    "whisper": ("whisper-base", {}, 2, 32, (5, 26)),
    "mamba2": ("mamba2-370m", {}, 2, 64, (9, 50)),
    "llama3_bf16": ("llama3-405b", {"kv_cache_dtype": "bfloat16"}, 3, 64,
                    (10, 40, 61)),
}

#: (data, model) grids and the cell whose rules place the cache there
GRIDS = {
    "seq2": ((1, 2), "decode_32k"),
    "seq4": ((1, 4), "decode_32k"),
    "seq8": ((1, 8), "decode_32k"),
    "two_axes": ((2, 4), "long_500k"),      # T over (data, model)
    "slots_and_seq": ((2, 2), "decode_32k"),  # B over data, T over model
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's smoke-sized ops (several test
    workers share the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout(jc):
    """Where each of the port's layers lives in the reference's cache:
    ``(container, index, group or None, kind)`` in the port's order."""
    plan = jax_layer_plan(jc)
    return ([("groups", i, g, kind) for g in range(plan.n_groups)
             for i, kind in enumerate(plan.pattern)]
            + [("tail", j, None, kind) for j, kind in enumerate(plan.tail)])


def _to_jax(port: dict, jc) -> dict:
    """The port's cache layout (numpy; k/v (n_attn, B, KV, T, D), conv and
    state (n_ssm, ...), len (B,)) as the reference's cache tree."""
    T = port["k"].shape[3] if "k" in port else 1
    B = port["len"].shape[0]
    tree = jax.tree.map(np.array, jax_init_cache(jc, B, T))
    ai = si = 0
    for box, i, g, kind in _layout(jc):
        node = tree[box][i]
        if kind == "ssm":
            for key in ("conv", "state"):
                dst = node[key] if g is None else node[key][g]
                dst[...] = port[key][si]
            si += 1
        else:
            for key in ("k", "v"):
                dst = node["self"][key] if g is None else node["self"][key][g]
                dst[...] = port[key][ai]
            ai += 1
    tree["len"] = np.asarray(port["len"], np.int32)
    return jax.tree.map(jnp.asarray, tree)


def _from_jax(tree, jc) -> dict:
    """The reference's cache tree in the port's layout (numpy)."""
    out = {"k": [], "v": [], "conv": [], "state": []}
    for box, i, g, kind in _layout(jc):
        node = tree[box][i]
        keys = ("conv", "state") if kind == "ssm" else ("k", "v")
        for key in keys:
            leaf = node[key] if kind == "ssm" else node["self"][key]
            leaf = np.asarray(leaf)
            out[key].append(leaf if g is None else leaf[g])
    return {k: np.stack(v) for k, v in out.items() if v}


def _np_param(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def _weights(tc, jc):
    """The port's seeded weights and the same values in the reference's
    tree (each pattern position's layers stacked, then the tail), checked
    against the reference's own structure; ``from_jax_numpy`` of the
    latter gives the former back."""
    tp = init_params(tc, torch.Generator().manual_seed(0), "cpu")
    plan = jax_layer_plan(jc)
    P = len(plan.pattern)

    def tree(p):
        return {k: tree(v) for k, v in p.items()} if isinstance(p, dict) \
            else _np_param(p)

    def stack(layers):
        return jax.tree.map(lambda *xs: np.stack(xs), *map(tree, layers)) \
            if layers[0] else {}

    layers = tp["layers"]
    jp = {"embed": tree(tp["embed"]), "norm_f": tree(tp["norm_f"]),
          "groups": [stack([layers[g * P + i] for g in range(plan.n_groups)])
                     for i in range(P)],
          "tail": [tree(layers[plan.n_groups * P + j])
                   for j in range(len(plan.tail))]}
    for key in ("shared", "enc_norm_f", "enc_pos", "dec_pos"):
        if key in tp:
            jp[key] = tree(tp[key])
    if "enc_layers" in tp:
        jp["enc_groups"] = [stack(tp["enc_layers"])]
    want = jax.eval_shape(lambda k: jax_init(jc, k), jax.random.PRNGKey(0))
    assert jax.tree.structure(jp) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = from_jax_numpy(jp, tc, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                 tree_leaves(tp)))
    return tp, jax.tree.map(jnp.asarray, jp)


def _np_of(t: torch.Tensor) -> np.ndarray:
    if t.dtype == F8:
        return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _torch_of(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(F8)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def _check_cache(got: dict, want: dict, *, placed: bool = False):
    for key, w in want.items():
        g = _np_of(got[key])
        if w.dtype == ml_dtypes.float8_e4m3fn:
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                          err_msg=key)
        elif placed and w.dtype == ml_dtypes.bfloat16:
            _close(g, w, PLACED_CACHE_TOL_BF16)
        else:
            _close(g, w, CACHE_TOL)


@pytest.fixture(scope="module")
def reference():
    """Per case: the configs, the port's weights, the seeded cache (port
    layout, numpy), the encoder output, the reference's logits and caches
    after each of ``STEPS`` steps, and the tokens fed."""
    memo, weights = {}, {}

    def get(name):
        if name in memo:
            return memo[name]
        arch, kw, B, T, lens = CASES[name]
        kw = {"compute_dtype": "float32", **kw}
        jc = dataclasses.replace(jax_smoke(arch), **kw)
        tc = dataclasses.replace(get_smoke_config(arch), **kw)
        if arch not in weights:     # the KV dtype leaves the weights as
            weights[arch] = _weights(tc, jc)  # they are
        tp, jp = weights[arch]
        rng = np.random.default_rng(3)
        shapes = {k: tuple(v.shape) for k, v in init_cache(
            tc, B, T, device="meta").items() if k != "len"}
        kv_dt = jnp.dtype(jc.kv_cache_dtype or jc.compute_dtype)
        port = {}
        for key, shape in shapes.items():
            x = rng.standard_normal(shape).astype(np.float32)
            port[key] = np.asarray(jnp.asarray(x).astype(kv_dt)) \
                if key in ("k", "v") else x
        port["len"] = np.asarray(lens, np.int32)
        enc = None
        if jc.family == "encdec":
            enc = rng.standard_normal((B, 8, jc.d_model)).astype(np.float32)
        tokens = rng.integers(0, jc.vocab_size - 1, (STEPS, B, 1)).astype(
            np.int32)
        jcache = _to_jax(port, jc)
        kw_enc = {} if enc is None else {"enc_out": jnp.asarray(enc)}
        step = jax.jit(lambda c, t: jax_decode_step(jc, jp, c, t, **kw_enc))
        outs = []
        for s in range(STEPS):
            logits, jcache = step(jcache, jnp.asarray(tokens[s]))
            outs.append((np.asarray(logits), _from_jax(jcache, jc)))
        memo[name] = (tc, tp, port, enc, tokens, outs)
        return memo[name]

    return get


def _port_cache(port: dict) -> dict:
    return {k: _torch_of(v) if k != "len" else torch.from_numpy(v.copy())
            for k, v in port.items()}


def _run_split(reference, name, grid, cell, *, placed: bool = False):
    """The case's 3 steps over its cache placed on ``grid`` by ``cell``'s
    specs, with whole weights or (``placed``) weights placed by the
    ``params`` specs, against the reference's."""
    tol = PLACED_LOGIT_TOL if placed else LOGIT_TOL
    tc, tp, port, enc, tokens, outs = reference(name)
    mesh = compat_make_mesh(grid, ("data", "model"), device="cpu")
    rules = rules_for_cell(mesh, SHAPE_CELLS[cell], tc)
    cache = place_cache(_port_cache(port), mesh, rules)
    if placed:
        tp = place_tree(tp, mesh, rules, kind="params")
    enc_out = None if enc is None else torch.from_numpy(enc)
    for s in range(STEPS):
        logits, cache = decode_step(tc, tp, cache, torch.from_numpy(
            tokens[s]), enc_out=enc_out)
        want_logits, want_cache = outs[s]
        _close(logits.numpy(), want_logits, tol)
        assert np.array_equal(logits.numpy().argmax(-1),
                              want_logits.argmax(-1))
        _check_cache(gather_tree(cache), want_cache, placed=placed)
    np.testing.assert_array_equal(cache["len"].numpy(),
                                  port["len"] + STEPS)
    return cache


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("name", list(CASES))
def test_split_decode_matches_jax(reference, name, grid):
    """3 steps over the placed cache against the reference's
    ``decode_step``: logits within 1e-5 of their scale, the caches
    equal after each step."""
    shape, cell = GRIDS[grid]
    cache = _run_split(reference, name, shape, cell)
    leaf = cache["k" if "k" in cache else "state"]
    assert isinstance(leaf, Placed)
    assert len(leaf.blocks) == shape[0] * shape[1]


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("name", list(CASES))
def test_placed_weights_split_decode_matches_jax(reference, name, grid):
    """:func:`test_split_decode_matches_jax` with the weights placed by
    their ``params`` specs too, each block gathered as it runs: logits
    within 1e-4 of the reference's scale, the same greedy tokens, the
    caches equal after each step."""
    shape, cell = GRIDS[grid]
    _run_split(reference, name, shape, cell, placed=True)


@pytest.mark.parametrize("name", ["llama3", "mixtral"])
def test_a_split_that_does_not_divide_keeps_the_sequence_whole(reference,
                                                               name):
    """T 64 over 3 positions: ``spec_for`` drops the axis, every position
    holds the whole cache (the reference replicates it), and the step is
    the reference's."""
    cache = _run_split(reference, name, (1, 3), "decode_32k")
    assert cache["k"].spec == (None, "data")
    assert cache["k"].distinct() == [0]
    for blk in cache["k"].blocks[1:]:
        assert torch.equal(blk, cache["k"].blocks[0])


def test_the_placement_is_the_specs():
    """llama3 smoke's cache on a 2 x 4 grid under ``long_500k``'s rules:
    T over (data, model), each position the contiguous 8th its
    coordinates give, its bytes the specs'; len and the rest on the
    lead."""
    cfg = get_smoke_config("llama3-405b")
    mesh = compat_make_mesh((2, 4), ("data", "model"), device="cpu")
    rules = rules_for_cell(mesh, SHAPE_CELLS["long_500k"], cfg)
    cache = init_cache(cfg, 1, 64, device="cpu")
    cache["k"].copy_(torch.arange(64.0).reshape(1, 1, 1, 64, 1).expand_as(
        cache["k"]))
    placed = place_cache(cache, mesh, rules)
    assert placed["k"].spec == cache_spec("k", cache["k"].shape, rules) == \
        (None, None, None, ("data", "model"))
    for i, blk in enumerate(placed["k"].blocks):
        assert blk.shape[3] == 8
        assert torch.equal(blk[0, 0, 0, :, 0], torch.arange(8.0 * i,
                                                            8.0 * i + 8))
    assert position_bytes({"k": placed["k"]}) == \
        [spec_bytes({"k": cache["k"]}, rules, kind="cache")] * 8
    assert placed["len"] is not None and not isinstance(placed["len"],
                                                        Placed)


def _blocks_of(k, v, n):
    """k/v (B, KV, T, D) split into n sequence blocks."""
    T = k.shape[2] // n
    return KVBlocks(
        k=[k[:, :, i * T:(i + 1) * T] for i in range(n)],
        v=[v[:, :, i * T:(i + 1) * T] for i in range(n)],
        regions=[(slice(0, k.shape[0]), slice(0, k.shape[1]),
                  slice(i * T, (i + 1) * T)) for i in range(n)],
        merge=list(range(n)))


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("n", [1, 4])
def test_decode_attention_matches_jax(n, window):
    """``decode_attention`` (whole) and ``decode_attention_split`` (4
    blocks) against the reference's ``decode_attention`` at G 3."""
    rng = np.random.default_rng(n)
    B, KV, G, T, D = 3, 2, 3, 32, 16
    q = rng.standard_normal((B, 1, KV * G, D)).astype(np.float32)
    k = rng.standard_normal((B, KV, T, D)).astype(np.float32)
    v = rng.standard_normal((B, KV, T, D)).astype(np.float32)
    kv_len = np.array([5, 20, 32], np.int32)
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len),
        window=window))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tl = torch.from_numpy(kv_len)
    got = (decode_attention(tq, tk, tv, tl, window=window) if n == 1 else
           decode_attention_split(tq, _blocks_of(tk, tv, n), tl,
                                  window=window))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)


def test_a_fully_masked_block_adds_exactly_zero():
    """A block past every slot's length gives ``(NEG_INF, 0, 0)``, and the
    merge with it is bit for bit the merge without it; nothing is NaN,
    also for a cache of huge values behind the mask."""
    rng = np.random.default_rng(0)
    B, KV, G, T, D = 2, 2, 2, 16, 8
    qf = torch.from_numpy(rng.standard_normal((B, KV, G, D)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((B, KV, T, D)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((B, KV, T, D)).astype(
        np.float32))
    hi = torch.tensor([[5], [8]])
    full = slice(0, B), slice(0, KV)
    parts = [(full, *decode_partial(qf, k[:, :, :8], v[:, :, :8], 0, None,
                                    hi))]
    big = torch.full_like(v[:, :, 8:], 3e38)
    m, l, acc = decode_partial(qf, k[:, :, 8:], big, 8, None, hi)
    assert (m == NEG_INF).all() and (l == 0).all() and (acc == 0).all()
    s_self = torch.from_numpy(rng.standard_normal((B, KV, G)).astype(
        np.float32))
    v_self = torch.from_numpy(rng.standard_normal((B, KV, D)).astype(
        np.float32))
    without = merge_partials(parts, (B, KV, G, D), s_self, v_self)
    with_it = merge_partials(parts + [(full, m, l, acc)], (B, KV, G, D),
                             s_self, v_self)
    assert torch.isfinite(with_it).all()
    assert torch.equal(with_it, without)


DECODE_CELLS = [(a, c) for a in ARCHS for c in cells_for(a)
                if SHAPE_CELLS[c].kind == "decode"]


class _StandIn:
    """The production grid as ``spec_for`` reads a mesh: its axis sizes."""
    shape = {"data": 16, "model": 16}


def _shard_shape(shape, spec, sizes) -> tuple:
    """A leaf of ``shape``'s block on a grid of axis ``sizes`` by
    ``spec``: the reference's ``shard_shape``."""
    return tuple(n // math.prod(sizes[a] for a in (
        () if e is None else e if isinstance(e, tuple) else (e,)))
        for n, e in zip(shape, tuple(spec) + (None,) * len(shape)))


def _unstacked(spec, stacked: bool) -> tuple:
    spec = tuple(spec)
    return spec[1:] if stacked else spec


@pytest.mark.parametrize("arch,cell", DECODE_CELLS,
                         ids=[f"{a}-{c}" for a, c in DECODE_CELLS])
def test_cache_specs_match_the_reference(arch, cell):
    """Every leaf of the port's dense cache at the cell's batch and length
    has the spec of the reference's leaf of that name: its
    ``_cache_axes`` resolved by ``rules_for_cell(...).spec_for`` on the
    16 x 16 grid (the layer-stacking axis dropped on both sides)."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    sc, jsc = SHAPE_CELLS[cell], JAX_CELLS[cell]
    B, S = sc.global_batch, sc.seq_len
    jrules = jax_rules_for_cell(None, jsc, jcfg)
    jrules = JaxRules(mesh=_StandIn(), rules=jrules.rules)
    struct = jax.eval_shape(lambda: jax_init_cache(jcfg, B, S))
    want: dict = {}
    blocks: dict = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(struct)[0]:
        key = path[-1].key
        stacked = path[0].key == "groups"
        spec = jrules.spec_for(jax_cache_axes(tuple(p.key if hasattr(
            p, "key") else str(p.idx) for p in path), leaf.ndim),
            dims=leaf.shape)
        want.setdefault(key, set()).add(
            tuple(spec) if key == "len" else _unstacked(spec, stacked))
        blocks.setdefault(key, set()).add(_unstacked(_shard_shape(
            leaf.shape, spec, _StandIn.shape), stacked))
    rules = rules_for_cell(_StandIn(), sc, cfg)
    port = init_cache(cfg, B, S, device="meta")
    assert set(port) == set(want)
    for key, leaf in port.items():
        spec = cache_spec(key, leaf.shape, rules)
        got = spec if key == "len" else _unstacked(spec, True)
        assert want[key] == {got}, (key, got, want[key])
    # placed on the production grid: K/V and the SSM conv and state split
    # into the reference's shards, len whole on the lead
    mesh = make_production_mesh()
    placed = place_cache(port, mesh, rules_for_cell(mesh, sc, cfg))
    assert not isinstance(placed["len"], Placed)
    for key, leaf in placed.items():
        if key == "len":
            continue
        assert {_unstacked(leaf.spec, True)} == want[key], key
        assert {tuple(b.shape[1:]) for b in leaf.blocks} == blocks[key], \
            (key, blocks[key])


@pytest.mark.parametrize("arch,cell", DECODE_CELLS, ids=lambda x: x)
def test_dryrun_decode_cells_hold_the_specs_bytes(arch, cell):
    """Every decode cell's row (the encoder-decoder and SSM ones too)
    holds, at every position, the ``params`` specs' bytes of the 16 x 16
    grid plus the ``cache`` specs' bytes of the cell's whole cache, and
    each placed cache leaf's blocks are a production position's (the
    layer axis whole); the KV bytes a position those specs'."""
    cfg = get_config(arch)
    mesh = make_production_mesh()
    sc = SHAPE_CELLS[cell]
    rules = rules_for_cell(mesh, sc, cfg)
    spec = build_cell(arch, cfg, cell, rules)
    params, cache = spec.args[0], spec.args[1]
    full = init_cache(cfg, sc.global_batch, sc.seq_len, device="meta")
    full["len"] = torch.zeros((sc.global_batch,), dtype=torch.int32,
                              device="meta")
    want = spec_bytes(params, rules) + spec_bytes(full, rules, kind="cache")
    assert spec.static_bytes == [want] * spec.row.size
    for key, leaf in cache.items():
        if key == "len":
            continue
        assert isinstance(leaf, Placed), key
        shard = _shard_shape(full[key].shape,
                             cache_spec(key, full[key].shape, rules),
                             mesh.shape)
        assert tuple(leaf.blocks[0].shape[1:]) == shard[1:], key
        assert {b.shape for b in leaf.blocks} == {leaf.blocks[0].shape}
    if "k" in full:
        kv = spec_bytes({"k": full["k"], "v": full["v"]}, rules,
                        kind="cache")
        assert position_bytes({"k": cache["k"], "v": cache["v"]}) == \
            [kv] * spec.row.size
