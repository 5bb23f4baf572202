"""Batched LM serving engine: bucketed prefill + lockstep greedy decode.

The counterpart of the JAX package's ``serving/engine.py``; the same code
serves every family of ``models/lm.py``:

* **Bucketed batching.** Requests are grouped by prompt length, so each
  batch prefills and decodes in lockstep with one cache position.
* **Prefill via the decode path.** The prompt is teacher-forced through
  ``decode_step`` in a Python loop (the reference scans it with
  ``lax.scan``); this fills the KV caches and Mamba states token by
  token.  The prefill reads nothing back to the host but the MoE
  family's per-expert row counts.
* **Early-stop masking.** Finished requests (``stop_token`` or their token
  budget) keep decoding in lockstep with their outputs masked; the batch
  retires when all are done.
* **Fixed cache.** One cache of (batch, max_len) per batch, written in
  place by every step.  A batch decodes at most ``max_len - prompt - 1``
  new tokens, as in the reference; a prompt longer than ``max_len``
  raises (the reference's cache update would clamp it silently).
* **Cross K/V.** Audio and vlm models attend to frontend features
  (``cross_feats``, (1, S, d) or (B, S, d); the first row serves every
  request), projected into each cross layer's K/V once per batch, when
  its cache is made, as the reference does.

The engine runs on the device its parameters live on.  ``decode_steps``
counts the ``decode_step`` calls it has made (prefill and decode).

Sharded (``pol`` from ``sharding.make_policy(mesh, ..., kind="decode")``
and parameters placed by ``sharding.distribute_model``), every rank of
the mesh runs the same engine on the same requests: each fresh cache is
placed by ``sharding.cache_shardings`` (``place_cache``), the cross K/V
in its layout, and every step's next tokens come back whole on every
rank, so all ranks append the same outputs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.models import common, lm


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 512           # cache capacity (prompt + generation)
    max_batch: int = 8           # requests per bucket batch
    stop_token: int = -1         # -1: never stop early


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    latency_s: float = 0.0


class Engine:
    """Batched greedy-decode engine over a fixed parameter set."""

    def __init__(self, cfg, params: lm.LM, scfg: ServeConfig = ServeConfig(),
                 *, pol=None, cross_feats=None):
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.pol = pol or common.NO_SHARDING
        self.device = params.embed.tok.device
        self.cross_feats = (None if cross_feats is None else
                            torch.as_tensor(cross_feats).to(self.device))
        self.decode_steps = 0

    def _fresh_cache(self, batch: int):
        cache = lm.init_cache(self.cfg, batch, self.scfg.max_len,
                              device=self.device)
        if self.pol.mesh is not None:
            from repro_torch.distributed import sharding
            cache = sharding.place_cache(cache, self.pol.mesh, batch=batch)
        if lm.cross_sites(self.cfg):
            if self.cross_feats is None:
                raise ValueError(f"family {self.cfg.family!r} serves "
                                 "against frontend features: pass "
                                 "cross_feats")
            feats = self.cross_feats[:1].expand(
                batch, *self.cross_feats.shape[1:])
            k, v = lm.precompute_cross_kv(self.params, self.cfg, feats,
                                          pol=self.pol)
            cache = cache._replace(cross_k=k, cross_v=v)
        return cache

    def _step(self, cache, token):
        self.decode_steps += 1
        return lm.serve_step(self.params, cache, token, self.cfg,
                             pol=self.pol)

    def run_batch(self, requests: Sequence[Request]) -> None:
        """Prefill + decode one equal-prompt-length batch, in place."""
        assert len({len(r.prompt) for r in requests}) == 1, "bucket invariant"
        t0 = time.time()
        B = len(requests)
        Tp = len(requests[0].prompt)
        if Tp > self.scfg.max_len:
            raise ValueError(f"prompt of {Tp} tokens exceeds the cache "
                             f"capacity max_len={self.scfg.max_len}")
        prompts = torch.tensor([r.prompt for r in requests],
                               dtype=torch.int64, device=self.device)
        cache = self._fresh_cache(B)
        for t in range(Tp):
            token, cache = self._step(cache, prompts[:, t])

        budget = max(r.max_new_tokens for r in requests)
        budget = min(budget, self.scfg.max_len - Tp - 1)
        alive = np.ones(B, bool)
        for _ in range(budget):
            token, cache = self._step(cache, token)
            ids = token.cpu().numpy()
            for i, r in enumerate(requests):
                if not alive[i]:
                    continue
                r.output.append(int(ids[i]))
                if (len(r.output) >= r.max_new_tokens
                        or int(ids[i]) == self.scfg.stop_token):
                    alive[i] = False
            if not alive.any():
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.time() - t0
        for r in requests:
            r.done = True
            r.latency_s = dt

    def serve(self, requests: Sequence[Request]) -> Dict[str, float]:
        """Bucket by prompt length, run every bucket, return stats."""
        buckets: Dict[int, List[Request]] = {}
        for r in requests:
            buckets.setdefault(len(r.prompt), []).append(r)
        t0 = time.time()
        for _, bucket in sorted(buckets.items()):
            for i in range(0, len(bucket), self.scfg.max_batch):
                self.run_batch(bucket[i:i + self.scfg.max_batch])
        wall = time.time() - t0
        toks = sum(len(r.output) for r in requests)
        return {"requests": len(requests), "tokens": toks,
                "wall_s": wall,
                "tok_per_s": toks / wall if wall else 0.0,
                "buckets": len(buckets)}


def synthetic_requests(n: int, vocab: int, *, prompt_lens=(8, 16),
                       max_new: int = 16, seed: int = 0) -> List[Request]:
    """The reference's synthetic stream: the same numpy draws, so both
    packages make the same requests for the same seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.choice(prompt_lens))
        out.append(Request(
            uid=i,
            prompt=rng.integers(0, vocab, size=plen).tolist(),
            max_new_tokens=max_new))
    return out
