"""Serving engines: the dense per-slot ``Engine`` and the paged
``PagedEngine`` with chunked prefill.

``Engine`` is the port of the JAX package's dense engine: every slot owns
a (KV, max_len, D) K/V buffer per attention layer.  ``prefill`` runs a
whole batch of prompts in one batched step, ``decode`` one step for every
slot, and ``insert`` prefills one request into a batch-1 cache and splices
it into its slot's row in place, the other slots untouched — the
continuous batching ``ServeScheduler`` drives.  After the first prefill the
cache ``len`` is (B,), one length per slot, so an inserted request
attends, RoPEs and writes at its own position.  An encoder-decoder model
(whisper) keeps its encoder output beside the cache, (B, T, d) in the
compute dtype: ``prefill`` and ``insert`` run the encoder on their
``enc_embeds`` and ``insert`` splices the slot's row, and every step
recomputes the cross K/V from it, as the reference does.  The reference
counts the traces of its three jitted programs; the port compiles nothing, so
``trace_count`` counts the distinct input-shape signatures each of
``prefill``, ``decode`` and ``splice`` has seen — what the traces count.

``PagedEngine`` (DESIGN.md §9): attention
layers share one page pool ``(num_pages, KV, page_size, D)`` per layer and
per K/V; a slot's cache is whatever pages the scheduler's allocator gave
it, recorded in a host-side page table ``(batch, max_pages_per_slot)``
that is mirrored to the device whenever it changes.  SSM layers keep a
dense per-slot conv tail and SSD state instead (no pages), so a decode
step takes a live mask that freezes the state of slots between prefill
chunks, and the prefix cache stays off for models with SSM layers.  Page 0 is the trash
page: free (and mid-prefill) slots' rows point at it, so the
always-full-batch decode step writes their dead K/V somewhere harmless,
and every read of it yields zeros.

Prefill is chunked (``prefill_chunk``-sized page-aligned chunks, the last
one padded to a bucket), each chunk attending over the slot's earlier pages
plus itself, so the scheduler can interleave decode steps between the
chunks of a long prompt.  During a multi-chunk prefill the slot's live
table row stays on the trash page; ``commit_slot`` installs its real row
after the last chunk.

``PagedEngine(mesh=)`` (DESIGN.md §13) spans a ``(dp, tp)`` device grid
(``serve/mesh.py``) from this one process: data row r holds the slots and
pages of the scheduler's device group r, with its own cache, and splits
each attention layer by KV head over its tensor-parallel positions, each
with its own page pools, and the experts and vocabulary where their specs
split them.  Every call routes a slot to its row (its local
slot index and local page ids), and ``decode`` runs each row over its own
slots and returns the logits in slot order.  Without a mesh the engine
runs the same code on the 1 x 1 grid of its device: one row of every slot
and page, with one shard of every head.

Both engines count their decode calls and the shape signatures of their
steps (``trace_count``).  They run on the card unless the caller asks for the
CPU: ``device="cuda"`` (the default) raises where no CUDA device exists.
Weights are cast to the compute dtype once, at construction — the per-call
casts of the reference, done once.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.layers import cast_weights, dtype_of
from ..models.transformer import (check_supported, chunk_prefill_step,
                                  decode_step, encode, init_cache,
                                  layer_plan)
from ..parallel.sharding import ShardingRules
from .mesh import (MeshRow, ServeMesh, kv_head_split, local_mesh,
                   per_device_pool_bytes, row_ranges, serve_rules,
                   shard_paged_cache, shard_params)

__all__ = ["Engine", "PagedEngine", "SamplingParams", "count_generated",
           "chunk_plan", "chunk_buckets_for", "sample", "resolve_device",
           "probe_device"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0       # 0 => greedy
    top_k: int = 0                 # 0 => no top-k filter
    stop_token: int = -1           # -1 => never stop early


def resolve_device(device) -> torch.device:
    """The port's entry points run on the card: a CUDA device must exist
    when one is asked for (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           f"is available (pass device='cpu' to run the "
                           f"plain PyTorch path on the CPU)")
    return dev


def probe_device(device: torch.device) -> bool:
    """Serve-layer health probe (DESIGN.md §14): one tiny op must run on
    ``device`` and its result come back to the host.  Returns False on the
    error a lost or faulted device raises (PyTorch reports CUDA errors as
    ``RuntimeError``; ``torch.AcceleratorError`` is one) instead of
    raising, so group failover keeps the group quarantined and retries;
    any other error is a bug and propagates."""
    try:
        x = torch.ones((2,), dtype=torch.int32, device=device)
        return int(x.sum().item()) == 2
    except RuntimeError:
        return False


def count_generated(out: np.ndarray, stop_token: int) -> int:
    """Real generated tokens in a ``generate`` result: stop-token padding
    after a sequence terminated does not count (the first stop token
    itself does — the model produced it)."""
    out = np.asarray(out)
    if stop_token < 0:
        return int(out.size)
    total = 0
    for row in out:
        hits = np.flatnonzero(row == stop_token)
        total += int(hits[0]) + 1 if hits.size else row.size
    return total


def sample(logits: torch.Tensor, sp: SamplingParams,
           generator: torch.Generator | None = None) -> np.ndarray:
    """Next token per row from the last position's logits (B, S, V):
    greedy argmax at temperature 0 (ties to the lowest id), else a draw
    from the softmax at ``sp.temperature`` with ``generator``.  The top-k
    filter keeps the logits at or above the k-th largest."""
    lg = logits[:, -1, :].float()
    if sp.top_k:
        thresh = torch.topk(lg, sp.top_k, dim=-1).values[:, -1:]
        lg = torch.where(lg < thresh, float("-inf"), lg)
    if sp.temperature <= 0.0:
        ids = torch.argmax(lg, dim=-1)
    else:
        probs = torch.softmax(lg / sp.temperature, dim=-1)
        ids = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return ids.to(torch.int32).cpu().numpy()


def chunk_buckets_for(prefill_chunk: int, page_size: int) -> tuple[int, ...]:
    """Length buckets for the FINAL (partial) chunk of a prompt: power-of-two
    multiples of the page size up to the full chunk length."""
    buckets = {prefill_chunk}
    b = page_size
    while b < prefill_chunk:
        buckets.add(b)
        b *= 2
    return tuple(sorted(buckets))


def chunk_plan(true_len: int, prefill_chunk: int,
               buckets: Sequence[int], *,
               start: int = 0) -> list[tuple[int, int, int]]:
    """Split a prompt into page-aligned chunks: full ``prefill_chunk``-sized
    chunks, then the remainder padded up to the smallest fitting bucket.
    Returns ``[(start, bucket_len, valid_in_chunk), ...]``.

    ``start`` (a chunk-aligned offset, prefix-cache hits) begins the plan at
    a later position; the result is exactly the suffix of the ``start=0``
    plan, so the final chunk — whose logits seed the first sampled token —
    is the one a full prefill would run."""
    if true_len <= 0:
        raise ValueError(f"true_len {true_len} must be positive")
    if not 0 <= start < true_len:
        raise ValueError(f"start {start} outside [0, {true_len})")
    if start % prefill_chunk:
        raise ValueError(f"start {start} must be chunk-aligned "
                         f"(prefill_chunk {prefill_chunk}) so the plan is a "
                         f"suffix of the full-prefill plan")
    plan = []
    while true_len - start > prefill_chunk:
        plan.append((start, prefill_chunk, prefill_chunk))
        start += prefill_chunk
    rem = true_len - start
    fitting = [b for b in buckets if b >= rem]
    if not fitting:
        raise ValueError(f"no chunk bucket fits remainder {rem} "
                         f"(buckets {tuple(buckets)})")
    plan.append((start, min(fitting), rem))
    return plan


def _as_tokens(tokens, device) -> torch.Tensor:
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(tokens, np.int32), device=device)


def _as_embeds(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class Engine:
    """Dense serving engine: per-slot K/V buffers of ``max_len`` positions,
    batched prefill, one decode step for the whole batch, and slot inserts.

    The batched prefill runs the path's kernel on a CUDA engine (the flash
    forward, or the SSD kernel) and the plain versions on the CPU.
    ``params`` are the port's parameters; the engine
    keeps a copy on ``device`` with the weights cast to the compute dtype.
    The reference's ``donate_cache`` has no counterpart: the port updates
    the cache in place.
    """

    def __init__(self, cfg: ModelConfig, params, *, batch: int, max_len: int,
                 device="cuda"):
        check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = cast_weights(
            _to_device(params, self.device), dtype_of(cfg.compute_dtype))
        self.batch, self.max_len = batch, max_len
        # step name -> the input shapes it has run at
        self._shapes: dict[str, set] = collections.defaultdict(set)
        self.n_decode_calls = 0
        self.cache = None
        self._enc_out = None       # encoder-decoder: (B, T, d) encoder output

    def trace_count(self, name: str) -> int:
        """Distinct input-shape signatures ``name`` (prefill | decode |
        splice) has run at — the reference's trace count."""
        return len(self._shapes[name])

    def probe_device(self) -> bool:
        """Health probe of the engine's device (see :func:`probe_device`)."""
        return probe_device(self.device)

    # -- lifecycle -------------------------------------------------------------
    def fresh_cache(self) -> dict:
        return init_cache(self.cfg, self.batch, self.max_len,
                          device=self.device)

    def ensure_batch(self, *, enc_len: int | None = None) -> None:
        """Allocate the empty live batch (all slots free, zero lengths) so
        insert-driven serving can start without a full-batch prefill.  An
        encoder-decoder model's ``enc_len`` sizes the encoder-output buffer
        the inserts splice into (zeros in the compute dtype)."""
        if self.cache is None:
            cache = self.fresh_cache()
            cache["len"] = torch.zeros((self.batch,), dtype=torch.int32,
                                       device=self.device)
            self.cache = cache
        if self.cfg.family == "encdec" and self._enc_out is None:
            if enc_len is None:
                raise ValueError("encdec ensure_batch() needs enc_len to "
                                 "size the encoder-output buffer")
            self._enc_out = torch.zeros(
                (self.batch, enc_len, self.cfg.d_model),
                dtype=dtype_of(self.cfg.compute_dtype), device=self.device)

    def _prefill(self, cache: dict, tokens: torch.Tensor, last_idx: int,
                 enc_embeds=None):
        """Batched prefill of ``tokens`` (B, S) into the fresh ``cache``:
        the logits at the true last token ``last_idx`` (the pad tail of a
        bucketed prompt picks nothing, and SSM layers mask it out of the
        state), ``len`` broadcast to (B,), and an encoder-decoder model's
        encoder output of ``enc_embeds`` (None for the other families)."""
        self._shapes["prefill"].add(tuple(tokens.shape))
        enc_out = None
        if self.cfg.family == "encdec":
            if enc_embeds is None:
                raise ValueError(f"{self.cfg.name}: an encoder-decoder "
                                 f"prefill needs enc_embeds")
            enc_out = encode(self.cfg, self.params,
                             _as_embeds(enc_embeds, self.device))
        logits, cache = decode_step(self.cfg, self.params, cache, tokens,
                                    valid_len=last_idx + 1, enc_out=enc_out)
        cache["len"] = cache["len"].expand(tokens.shape[0]).clone()
        return logits[:, last_idx:last_idx + 1], cache, enc_out

    def prefill(self, tokens, *, enc_embeds=None) -> torch.Tensor:
        """tokens: (batch, S); an encoder-decoder model's ``enc_embeds``
        (batch, T, d).  Returns the last position's logits (batch, 1,
        V)."""
        tokens = _as_tokens(tokens, self.device)
        logits, self.cache, self._enc_out = self._prefill(
            self.fresh_cache(), tokens, tokens.shape[1] - 1, enc_embeds)
        return logits

    def decode(self, tokens) -> torch.Tensor:
        """tokens: (batch, 1) — one step for every slot.  Returns logits
        (batch, 1, V) on the engine's device."""
        tokens = _as_tokens(tokens, self.device)
        self._shapes["decode"].add((tuple(tokens.shape),
                                    tuple(self.cache["len"].shape)))
        self.n_decode_calls += 1
        logits, self.cache = decode_step(self.cfg, self.params, self.cache,
                                         tokens, enc_out=self._enc_out)
        return logits

    # -- sampling --------------------------------------------------------------
    def generate(self, tokens, *, max_new: int,
                 sp: SamplingParams = SamplingParams(),
                 generator: torch.Generator | None = None,
                 enc_embeds=None) -> np.ndarray:
        """Greedy or temperature generation for a full batch: prefill (with
        an encoder-decoder model's ``enc_embeds``), then ``max_new`` tokens
        (the first sampled from the prefill's logits).  Returns (batch,
        max_new) ids, stop-token padded after a row stops; stops early once
        every row has.  Temperature > 0 draws from ``generator`` (one
        seeded with 0 on the engine's device when None)."""
        if sp.temperature > 0 and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        logits = self.prefill(tokens, enc_embeds=enc_embeds)
        out = []
        done = np.zeros((logits.shape[0],), bool)
        for _ in range(max_new):
            ids = sample(logits, sp, generator)
            if sp.stop_token >= 0:
                ids = np.where(done, sp.stop_token, ids).astype(np.int32)
                done |= ids == sp.stop_token
            out.append(ids)
            if done.all():
                out.extend([np.full_like(ids, sp.stop_token)]
                           * (max_new - len(out)))
                break
            logits = self.decode(ids[:, None])
        return np.stack(out, axis=1)

    # -- continuous batching -----------------------------------------------------
    def insert(self, slot: int, tokens_1xS, *, true_len: int | None = None,
               enc_embeds=None) -> torch.Tensor:
        """Prefill one request into slot ``slot`` without disturbing the
        other slots: a batched prefill into a fresh batch-1 cache, spliced
        into the slot's row in place.

        ``tokens_1xS`` may be right-padded to a bucket length; ``true_len``
        is the unpadded prompt length (the full width by default), and the
        slot's ``len`` becomes it.  An encoder-decoder model needs the
        request's ``enc_embeds`` (1, T, d), T the live batch's encoder
        length: its encoder output is spliced into the slot's row beside
        the cache.  Returns the logits of the true last prompt token, (1,
        1, V)."""
        if self.cache is None:
            raise RuntimeError("insert() needs a live batch; call prefill() "
                               "first")
        tokens = _as_tokens(tokens_1xS, self.device)
        S = tokens.shape[1]
        true_len = S if true_len is None else int(true_len)
        if not 0 < true_len <= S:
            raise ValueError(f"true_len {true_len} outside (0, {S}]")
        if not 0 <= slot < self.batch:
            raise ValueError(f"slot {slot} outside [0, {self.batch})")
        if self.cfg.family == "encdec":
            if enc_embeds is None:
                raise ValueError(
                    "inserting into an encdec engine requires enc_embeds — "
                    "the slot's encoder output must be spliced alongside its "
                    "KV cache")
            if self._enc_out is None:
                raise RuntimeError("encdec insert() needs a live batch with "
                                   "encoder output; call prefill() first")
            if enc_embeds.shape[1] != self._enc_out.shape[1]:
                raise ValueError(
                    f"enc_embeds length {enc_embeds.shape[1]} != batch "
                    f"encoder length {self._enc_out.shape[1]}")
        mini = init_cache(self.cfg, 1, self.max_len, device=self.device)
        logits, mini, enc_out = self._prefill(mini, tokens, true_len - 1,
                                              enc_embeds)
        self._splice(mini, enc_out, slot, true_len)
        return logits

    def _splice(self, mini: dict, enc_out, slot: int, true_len: int) -> None:
        """Copy a batch-1 cache (and an encoder-decoder model's encoder
        output row) into row ``slot`` of the live batch."""
        self._shapes["splice"].add(tuple(tuple(t.shape)
                                         for t in mini.values()))
        for key, full in self.cache.items():
            if key != "len":
                full[:, slot] = mini[key][:, 0]
        self.cache["len"][slot] = true_len
        if enc_out is not None:
            self._enc_out[slot] = enc_out[0]


class PagedEngine:
    """Serving engine over a paged KV cache with chunked prefill.

    ``attn_impl`` picks the decode attention: ``auto`` runs the paged
    flash-decode kernel on a CUDA engine and the gather path on the CPU;
    ``kernel`` and ``ref`` pin one (``ref`` on the card is for comparing
    the kernel with its plain version).  ``params`` are the port's
    parameters (``weights.init_params`` or ``weights.from_jax_numpy``); the
    engine keeps a copy on ``device`` with the weights cast to the compute
    dtype.

    ``mesh`` (a :class:`~repro_torch.serve.mesh.ServeMesh`) shards the
    engine over its grid: ``device`` must be its first position's (its
    type, and its index where both name one); the weights are placed per
    row and shard (``mesh.shard_params``) and the caches per row
    (``mesh.shard_paged_cache``).  ``ServeScheduler`` must then split the
    slots and pages into ``dp`` device groups whose ranges are the rows'
    (:meth:`check_groups`).  Without a mesh the grid is ``device`` alone
    (``mesh.local_mesh``).  ``params`` is row 0's copy of the weights.
    """

    def __init__(self, cfg: ModelConfig, params, *, batch: int, max_len: int,
                 page_size: int = 16, num_pages: int | None = None,
                 prefill_chunk: int = 64, mesh=None, attn_impl: str = "auto",
                 device="cuda"):
        if cfg.family == "encdec":
            raise NotImplementedError("paged serving for encdec models "
                                      "(cross-attention buffers)")
        check_supported(cfg)
        if prefill_chunk % page_size:
            raise ValueError(f"prefill_chunk {prefill_chunk} must be a "
                             f"multiple of page_size {page_size}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch, self.max_len = batch, max_len
        self.page_size = page_size
        self.attn_impl = attn_impl
        self.chunk_len = prefill_chunk
        self.max_pages = -(-max_len // page_size)       # per-slot table width
        # default pool: batch × max_len tokens plus the trash page
        self.num_pages = (1 + batch * self.max_pages if num_pages is None
                          else num_pages)
        self.mesh = mesh
        if mesh is None:
            grid = local_mesh(self.device)
        else:
            if not isinstance(mesh, ServeMesh):
                raise TypeError(f"mesh must be a ServeMesh "
                                f"(serve.mesh.build_serve_mesh), got "
                                f"{type(mesh).__name__}")
            lead = mesh.devices[0][0]
            if (self.device.type != lead.type
                    or None not in (self.device.index, lead.index)
                    and self.device.index != lead.index):
                raise ValueError(f"device {device!r} disagrees with the "
                                 f"mesh's first position {lead}")
            self.device = lead
            grid = mesh
        ranges = row_ranges(batch, self.num_pages, grid.spec.dp)
        if not all(slots and pages for slots, pages in ranges):
            raise ValueError(f"{batch} slots and {self.num_pages - 1} "
                             f"usable pages cannot cover {grid.spec.dp} "
                             f"data rows")
        rules = ShardingRules(mesh=grid, rules=serve_rules())
        n_split = kv_head_split(cfg, rules, num_pages=self.num_pages,
                                page_size=page_size)
        self.rows: list[MeshRow] = [
            MeshRow(slots=slots, pages=pages, devices=devs,
                    params=row_params, shards=shards, split=split)
            for (slots, pages), devs, (row_params, shards, split) in zip(
                ranges, grid.devices, shard_params(cfg, params, grid,
                                                   n_split))]
        self.params = self.rows[0].params
        self._row_of_slot = [r for r, row in enumerate(self.rows)
                             for _ in row.slots]
        self.chunk_buckets = chunk_buckets_for(prefill_chunk, page_size)
        # host-side page table; all-zero rows = trash page (slot empty)
        self.page_table = np.zeros((batch, self.max_pages), np.int32)
        # prefix caching shares pages between slots, which only the paged
        # attention pools support: SSM layers keep per-slot dense state
        # that a chunk prefill rebuilds position by position — there is no
        # page of it to hand a second request
        plan = layer_plan(cfg)
        self.supports_prefix_cache = "ssm" not in plan.pattern + plan.tail
        self.n_decode_calls = 0
        self.n_chunk_calls = 0
        self._shapes: dict[str, set] = collections.defaultdict(set)
        # device copy of the page table, refreshed only when it changed
        self._pt_device = None

    def trace_count(self, name: str) -> int:
        """Distinct input-shape signatures ``name`` (chunk_prefill |
        decode) has run at — the reference's trace count: one a chunk
        bucket, one decode."""
        return len(self._shapes[name])

    def probe_device(self, group: int | None = None) -> bool:
        """Health probe (see :func:`probe_device`) of every device of the
        grid, or of data row ``group``'s alone where the grid has more
        than one row: ``ServeScheduler.probe_group`` calls it before a
        quarantined group rejoins."""
        rows = (self.rows if group is None or len(self.rows) == 1
                else [self.rows[group]])
        return all(probe_device(d) for d in
                   dict.fromkeys(d for row in rows for d in row.devices))

    # -- lifecycle -------------------------------------------------------------
    def ensure_batch(self) -> None:
        """Allocate the empty live batch (all slots free, zero lengths,
        every table row on the trash page)."""
        if self.rows[0].cache is None:
            shard_paged_cache(self.cfg, self.rows, page_size=self.page_size)

    def _pools(self) -> list[torch.Tensor]:
        """The attention page pools (K and V of every shard; none for an
        attention-free model)."""
        self.ensure_batch()
        return [t for row in self.rows for sh in row.shards
                for t in (sh.k, sh.v)]

    def total_pool_bytes(self) -> int:
        """Attention page-pool bytes (K and V, every layer, every shard of
        a mesh; 0 for pure-SSM models — their dense per-slot state is not
        paged)."""
        return sum(t.numel() * t.element_size() for t in self._pools())

    def per_device_pool_bytes(self) -> int:
        """The most attention-pool bytes one grid position holds (the
        total without a mesh; TP=2 halves it when kv_heads divides, also
        where the positions share a card)."""
        self.ensure_batch()
        return per_device_pool_bytes(self.rows)

    def check_groups(self, groups) -> None:
        """Where the grid has more than one data row, fail unless the
        scheduler's device groups are the rows: ``dp`` of them, each with
        its row's slots and its pages inside its row's range
        (``pool_pages`` may shrink the ranges, not move them).  Each group
        is ``(slot_ids, page_lo, page_hi)``.  One row holds every slot and
        page, so any groups fit it.  The reference's GSPMD serves any
        split; this engine places each row's pages on its own devices."""
        if len(self.rows) == 1:
            return
        if len(groups) != len(self.rows):
            raise ValueError(f"a mesh with {len(self.rows)} data rows needs "
                             f"device_groups={len(self.rows)}, got "
                             f"{len(groups)}")
        for gid, ((slot_ids, lo, hi), row) in enumerate(zip(groups,
                                                            self.rows)):
            if tuple(slot_ids) != tuple(row.slots):
                raise ValueError(f"group {gid} slots {tuple(slot_ids)} are "
                                 f"not mesh row {gid}'s {tuple(row.slots)}")
            if not (row.pages.start <= lo and hi <= row.pages.stop):
                raise ValueError(
                    f"group {gid} pages [{lo}, {hi}) leave mesh row {gid}'s "
                    f"[{row.pages.start}, {row.pages.stop}) (pool_pages "
                    f"moved the groups' ranges)")

    def _row(self, slot: int, page_ids=()) -> tuple[MeshRow, int]:
        """The mesh row of ``slot`` and the slot's index in it; fails if a
        page of ``page_ids`` lies outside the row's range."""
        row = self.rows[self._row_of_slot[slot]]
        bad = [int(p) for p in page_ids if int(p) not in row.pages]
        if bad:
            raise ValueError(f"slot {slot}: page id(s) {bad} outside its mesh "
                             f"row's [{row.pages.start}, {row.pages.stop})")
        return row, slot - row.slots.start

    def pages_needed(self, true_len: int, max_new: int) -> int:
        """Pages a request needs to hold ``true_len`` prompt tokens plus
        ``max_new`` generated ones: the padded prefill span or the prompt +
        generation budget, whichever reaches further.  ``ServeScheduler``
        calls it with the whole budget (``reserve="lifetime"``) or with
        ``max_new=1`` and appends decode pages later (``reserve="demand"``).
        """
        plan = chunk_plan(true_len, self.chunk_len, self.chunk_buckets)
        span = max(plan[-1][0] + plan[-1][1], true_len + max_new)
        return -(-span // self.page_size)

    # -- chunked prefill -------------------------------------------------------
    def prefill_chunk(self, slot: int, tokens_1xC, page_ids, start: int,
                      valid_in_chunk: int) -> torch.Tensor:
        """Run one chunk through the slot's pages (``page_ids``: the slot's
        full allocation, host list).  Returns the logits at the chunk's true
        last token, (1, 1, V) — only the final chunk's are meaningful."""
        self.ensure_batch()
        ids = self._check_page_row(slot, page_ids)
        row = np.zeros((1, self.max_pages), np.int32)
        row[0, :len(ids)] = ids
        mrow, local = self._row(slot, ids)
        tokens = _as_tokens(tokens_1xC, mrow.device)
        self._shapes["chunk_prefill"].add(tuple(tokens.shape))
        logits, mrow.cache = chunk_prefill_step(
            self.cfg, mrow.params, mrow.cache, tokens, slot=local,
            start=int(start), valid_len=int(valid_in_chunk),
            pages_row=torch.as_tensor(mrow.local_pages(row),
                                      device=mrow.device),
            page_size=self.page_size, shards=mrow.shards, split=mrow.split)
        logits = logits.to(self.device)
        self.n_chunk_calls += 1
        return logits

    def _check_page_row(self, slot: int, page_ids) -> list[int]:
        """Fail fast on a bad table row: the trash page (id 0) mid-row would
        truncate the nonzero-prefix page count ``append_page`` depends on,
        an out-of-range id would index the pool out of bounds on the
        device, and an over-long row would overflow the table width."""
        ids = [int(p) for p in page_ids]
        if len(ids) > self.max_pages:
            raise ValueError(f"slot {slot}: {len(ids)} pages exceed the "
                             f"per-slot table width {self.max_pages}")
        bad = [p for p in ids if not 0 < p < self.num_pages]
        if bad:
            raise ValueError(f"slot {slot}: page id(s) {bad} outside "
                             f"(0, {self.num_pages}) — 0 is the reserved "
                             f"trash page")
        return ids

    def commit_slot(self, slot: int, page_ids) -> None:
        """Install the slot's pages into the live table — decode reads (and
        writes) go through them from the next step on."""
        ids = self._check_page_row(slot, page_ids)
        self._row(slot, ids)
        row = np.zeros((self.max_pages,), np.int32)
        row[:len(ids)] = ids
        self.page_table[slot] = row
        self._pt_device = None

    def append_page(self, slot: int, page_id: int) -> None:
        """Reserve-on-demand decode growth: append one page to a COMMITTED
        slot's live row, just before the decode write that crosses into it.
        The row's page count is its nonzero prefix."""
        if page_id <= 0:
            raise ValueError(f"page {page_id} is reserved (trash page) or "
                             f"invalid — appends take allocator pages >= 1")
        if page_id >= self.num_pages:
            raise ValueError(f"page {page_id} outside the pool "
                             f"(num_pages {self.num_pages}) — a foreign id "
                             f"would index the device pool out of bounds")
        n = int(np.count_nonzero(self.page_table[slot]))
        if n == 0:
            raise ValueError(f"slot {slot} is not committed (row on the "
                             f"trash page); append_page only grows live "
                             f"slots")
        if n >= self.max_pages:
            raise ValueError(f"slot {slot} table is full "
                             f"({self.max_pages} pages)")
        self._row(slot, [page_id])
        self.page_table[slot, n] = page_id
        self._pt_device = None

    def copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write primitive: duplicate page ``src``'s K/V block into
        ``dst`` in every attention layer's pool (SSM layers hold per-slot
        state, no pages to copy)."""
        for name, p in (("src", src), ("dst", dst)):
            if not 0 < p < self.num_pages:
                raise ValueError(f"copy_page {name} {p} outside "
                                 f"(0, {self.num_pages})")
        if src == dst:
            raise ValueError(f"copy_page onto itself (page {src})")
        self.ensure_batch()
        (row,) = [r for r in self.rows if src in r.pages]
        if dst not in row.pages:
            raise ValueError(f"copy_page {src} -> {dst} crosses mesh rows")
        s, d = row.local_pages([src, dst])
        for sh in row.shards:
            for pool in (sh.k, sh.v):
                pool[:, d] = pool[:, s]

    def remap_slot_page(self, slot: int, idx: int, page_id: int) -> None:
        """Replace ONE live table-row entry (COW remap: shared original ->
        private copy).  Only committed rows can be remapped."""
        if not 0 < page_id < self.num_pages:
            raise ValueError(f"page {page_id} outside (0, {self.num_pages})")
        if not 0 <= idx < self.max_pages:
            raise ValueError(f"row index {idx} outside [0, {self.max_pages})")
        if self.page_table[slot, idx] == 0:
            raise ValueError(f"slot {slot} row index {idx} is not live "
                             f"(trash page) — remap only swaps existing "
                             f"mappings")
        self._row(slot, [page_id])
        self.page_table[slot, idx] = page_id
        self._pt_device = None

    def free_slot(self, slot: int) -> None:
        """Retire (or preempt) the slot: its row points back at the trash
        page; its pages go back to the scheduler's allocator."""
        self.page_table[slot] = 0
        self._pt_device = None

    def insert(self, slot: int, tokens, *, true_len: int | None = None,
               page_ids=None, max_new: int = 0) -> torch.Tensor:
        """Convenience one-call insert: run every chunk back-to-back and
        commit the pages.  ``tokens``: (S,) or (1, S) prompt."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        true_len = len(toks) if true_len is None else int(true_len)
        if page_ids is None:
            raise ValueError("insert() needs the slot's allocated page_ids")
        need = self.pages_needed(true_len, max_new)
        if len(page_ids) < need:
            raise ValueError(f"slot {slot} got {len(page_ids)} pages, needs "
                             f"{need}")
        logits = None
        for start, blen, vlen in chunk_plan(true_len, self.chunk_len,
                                            self.chunk_buckets):
            ck = np.zeros((1, blen), np.int32)
            ck[0, :vlen] = toks[start:start + vlen]
            logits = self.prefill_chunk(slot, ck, page_ids, start, vlen)
        self.commit_slot(slot, page_ids)
        return logits

    # -- decode ----------------------------------------------------------------
    def decode(self, tokens, live_mask=None) -> torch.Tensor:
        """tokens: (batch, 1) — one step for every slot, page-table reads
        and writes.  ``live_mask`` (batch,) bool: slots whose per-slot SSM
        state may advance — mid-prefill slots must be masked out, or the
        interleaved decode would corrupt the state their next chunk
        continues from (their attention K/V needs no mask: the live page
        table parks them on the trash page).  Defaults to all-live.
        Returns logits (batch, 1, V) on the engine's device."""
        self.ensure_batch()
        tokens = _as_tokens(tokens, self.device)
        self._shapes["decode"].add(tuple(tokens.shape))
        mask = (None if live_mask is None else torch.as_tensor(
            np.asarray(live_mask, bool), device=self.device))
        if self._pt_device is None:
            # each row's local page table on its lead, refreshed only when
            # the table changed
            self._pt_device = [
                torch.tensor(row.local_pages(
                    self.page_table[row.slots.start:row.slots.stop]),
                    device=row.device) for row in self.rows]
        out = []
        for row, pt in zip(self.rows, self._pt_device):
            sl = slice(row.slots.start, row.slots.stop)
            logits, row.cache = decode_step(
                self.cfg, row.params, row.cache, tokens[sl].to(row.device),
                pages=pt, page_size=self.page_size,
                paged_impl=self.attn_impl,
                update_mask=None if mask is None else mask[sl].to(row.device),
                shards=row.shards, split=row.split)
            out.append(logits.to(self.device))
        self.n_decode_calls += 1
        return out[0] if len(out) == 1 else torch.cat(out)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
