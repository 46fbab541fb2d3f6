"""Deterministic synthetic data pipeline with per-host sharding + prefetch.

A copy of the reference's ``repro/data/pipeline.py`` (numpy only; the port
keeps its own copy): the stream is a pure function of (seed, step, host),
so a restart resumes bit-identically and the same seed gives the same
batches, bit for bit, as the reference.  Token streams are Zipf-distributed
with a masked tail.  :func:`to_device` turns a batch into tensors, and
:func:`make_batch_specs` gives a batch's stand-ins on the meta device (the
dry-run's inputs).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..models.config import ModelConfig

__all__ = ["DataConfig", "SyntheticLMStream", "Prefetcher", "to_device",
           "make_batch_specs"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    n_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2
    pad_frac: float = 0.02          # tail padding to exercise loss masks


class SyntheticLMStream:
    """Stateless-per-step synthetic LM batches."""

    def __init__(self, cfg: ModelConfig, dc: DataConfig):
        if dc.global_batch % dc.n_hosts:
            raise ValueError("global_batch must divide over hosts")
        self.cfg, self.dc = cfg, dc
        self.local_batch = dc.global_batch // dc.n_hosts

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.dc.seed, step, self.dc.host_id]))

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg, dc = self.cfg, self.dc
        rng = self._rng(step)
        B, S = self.local_batch, dc.seq_len
        V = cfg.vocab_size
        # Zipf tokens clipped to vocab
        toks = rng.zipf(dc.zipf_a, size=(B, S + 1)).astype(np.int64)
        toks = np.minimum(toks - 1, V - 1).astype(np.int32)
        mask = np.ones((B, S), np.float32)
        n_pad = int(S * dc.pad_frac)
        if n_pad:
            mask[:, S - n_pad:] = 0.0
        out = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1], "mask": mask}
        if cfg.family == "encdec":
            T = min(S, 1500)
            out["enc_embeds"] = rng.standard_normal(
                (B, T, cfg.d_model), dtype=np.float32)
            dec = min(cfg.decoder_len, S)
            out["tokens"] = toks[:, :dec]
            out["labels"] = toks[:, 1:dec + 1]
            out["mask"] = mask[:, :dec]
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def to_device(batch: dict, device) -> dict[str, torch.Tensor]:
    """A batch of numpy arrays as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def make_batch_specs(cfg: ModelConfig, batch: int, seq: int, *,
                     kind: str = "train") -> dict[str, torch.Tensor]:
    """Meta tensors of the shapes and dtypes of :class:`SyntheticLMStream`
    batches (the reference's ``ShapeDtypeStruct`` stand-ins)."""
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    f32, i32 = torch.float32, torch.int32
    if cfg.family == "encdec":
        dec = min(cfg.decoder_len, seq)
        specs = {"enc_embeds": spec((batch, seq, cfg.d_model), f32),
                 "tokens": spec((batch, dec), i32)}
        if kind == "train":
            specs["labels"] = spec((batch, dec), i32)
            specs["mask"] = spec((batch, dec), f32)
        return specs
    specs = {"tokens": spec((batch, seq), i32)}
    if kind == "train":
        specs["labels"] = spec((batch, seq), i32)
        specs["mask"] = spec((batch, seq), f32)
    return specs


class Prefetcher:
    """Background-thread prefetch (depth-bounded) — keeps the host data path
    off the device critical path."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)
            self.q.put(None)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
