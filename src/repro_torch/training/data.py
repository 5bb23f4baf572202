"""Data pipeline of the PyTorch port: deterministic synthetic LM streams
and memmap token files.

A copy of the JAX package's ``training/data.py`` (the port imports
nothing of it), with numpy drawing every batch, so a batch is byte-equal
to the reference's for the same ``(seed, step, shard, n_shards)``.  Both
sources are *stateless functions of (step, shard)*: a resumed or
re-sharded job regenerates exactly the batches it would have seen.
:func:`device_batch` copies a host batch to one device.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    source: str = "synthetic"       # "synthetic" | "memmap"
    path: Optional[str] = None      # token file for memmap
    seed: int = 1234


def _rng(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        (cfg.seed * 1_000_003 + step) * 65_537 + shard)


class SyntheticLM:
    """Markov-ish synthetic tokens: learnable structure, deterministic."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # A sparse bigram table gives the model something to learn.
        self._next = rng.integers(0, cfg.vocab_size,
                                  size=(cfg.vocab_size, 4), dtype=np.int32)

    def batch(self, step: int, shard: int = 0, n_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b = cfg.global_batch // n_shards
        rng = _rng(cfg, step, shard)
        toks = np.empty((b, cfg.seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=b)
        choices = rng.integers(0, 4, size=(b, cfg.seq_len))
        noise = rng.random((b, cfg.seq_len)) < 0.1
        rand = rng.integers(0, cfg.vocab_size, size=(b, cfg.seq_len))
        for t in range(cfg.seq_len):
            nxt = self._next[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class MemmapLM:
    """Token-file dataset: windows sampled deterministically per step."""

    def __init__(self, cfg: DataConfig):
        if not (cfg.path and os.path.exists(cfg.path)):
            raise FileNotFoundError(f"no token file at {cfg.path!r}")
        self.cfg = cfg
        self._tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch(self, step: int, shard: int = 0, n_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b = cfg.global_batch // n_shards
        n = len(self._tokens) - cfg.seq_len - 1
        starts = _rng(cfg, step, shard).integers(0, n, size=b)
        rows = np.stack([np.asarray(self._tokens[s:s + cfg.seq_len + 1])
                         for s in starts])
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def make_dataset(cfg: DataConfig):
    if cfg.source == "synthetic":
        return SyntheticLM(cfg)
    if cfg.source == "memmap":
        return MemmapLM(cfg)
    raise ValueError(cfg.source)


def device_batch(host_batch: Dict[str, np.ndarray], device
                 ) -> Dict[str, torch.Tensor]:
    """A host batch as tensors of the same dtypes on ``device``: to a CUDA
    device through pinned memory with a non-blocking copy, which the
    stream orders before the step that reads it."""
    device = torch.device(device)
    out = {}
    for k, v in host_batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def write_token_file(path: str, n_tokens: int, vocab: int, seed: int = 0):
    """Utility: materialize a synthetic token file for the memmap source."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, vocab, size=n_tokens, dtype=np.int32)
    arr.tofile(path)
    return path
