"""Cost-model memo cache: per-point results shared across searches.

Port of ``repro.serving.cost_cache``, telemetry included.  The cache key
is one *point* of the cost model -- ``(layer descriptor, PE, buffer,
dataflow)`` packed as the raw float32 bytes of the batcher's row -- and the
value is the point's ``(latency, energy, area, power)`` 4-vector.  Keying
on the raw model inputs (not on a workload name or an objective) is what
lets hits cross user boundaries: two users searching mobilenet under
different objectives, or two workloads that share a layer shape, reuse
each other's evaluations.

Thread-safe LRU with hit/miss/eviction accounting; all counting happens at
*unique-row* granularity (the batcher dedupes a dispatch's rows before it
consults the cache).

Every key is namespaced by a cost-model *version*: by default the content
hash of the port's cost-model sources and CUDA cost kernel
(:func:`repro_torch.costmodel.maestro.content_hash`), so a point evaluated
under one version of the model is never served under another, and entries
of the two packages never mix.

:class:`PersistentCostCache` keeps the entries on disk under
``cache_dir/<version>/`` as append-only shard files (each flush writes one
immutable shard through a tmp file and ``os.replace``), and loads every
shard when it opens; corrupt or truncated shards are skipped and counted.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import instrument as obs_instrument
from repro_torch.obs import state as obs_state


def model_version() -> str:
    """The default cache namespace: the port's cost-model content hash."""
    from repro_torch.costmodel import maestro

    return maestro.content_hash()


class CostMemoCache:
    """LRU memo of per-point cost evaluations.

    Keys are ``bytes`` (the packed f32 point row), internally prefixed with
    the model ``version`` tag; values are ``(4,)`` float32 arrays
    ``[latency, energy, area, power]``.
    """

    def __init__(self, capacity: int = 2 ** 20,
                 version: Optional[str] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.version = model_version() if version is None else str(version)
        self._vprefix = self.version.encode("ascii") + b":"
        self._data: "OrderedDict[bytes, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def get_many(self, keys) -> tuple:
        """Look up a batch of keys under one lock acquisition.

        Returns (values, miss_index): ``values`` is a list aligned with
        ``keys`` (None where missing); ``miss_index`` the positions to
        evaluate.  Counts one hit/miss per key.
        """
        t0 = time.perf_counter() if obs_state.enabled else 0.0
        values = []
        miss_index = []
        pre = self._vprefix
        with self._lock:
            for i, k in enumerate(keys):
                k = pre + k
                v = self._data.get(k)
                if v is None:
                    self.misses += 1
                    miss_index.append(i)
                else:
                    self.hits += 1
                    self._data.move_to_end(k)
                values.append(v)
        if obs_state.enabled:
            obs_instrument.CACHE_LOOKUP_SECONDS.observe(
                time.perf_counter() - t0)
            n_miss = len(miss_index)
            if n_miss:
                obs_instrument.CACHE_LOOKUPS.inc(n_miss, result="miss")
            if len(values) - n_miss:
                obs_instrument.CACHE_LOOKUPS.inc(
                    len(values) - n_miss, result="hit")
        return values, miss_index

    def put_many(self, keys, vals) -> None:
        """Insert key->(4,) rows; evicts least-recently-used past capacity."""
        pre = self._vprefix
        fresh: List[Tuple[bytes, np.ndarray]] = []
        with self._lock:
            ev0 = self.evictions
            for k, v in zip(keys, vals):
                pk = pre + k
                if pk not in self._data:
                    fresh.append((k, v))
                self._data[pk] = v
                self._data.move_to_end(pk)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.evictions += 1
            evicted = self.evictions - ev0
        if evicted and obs_state.enabled:
            obs_instrument.CACHE_EVICTIONS.inc(evicted)
        if fresh:
            self._on_insert(fresh)

    def _on_insert(self, fresh: List[Tuple[bytes, np.ndarray]]) -> None:
        """First-insertion hook (unprefixed key, (4,) f32 value pairs) --
        the persistence layer's write-behind point.  No-op in memory."""

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "entries": len(self._data),
                "capacity": self.capacity,
                "version": self.version,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": self.hit_rate,
            }

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def flush(self) -> int:
        """Persist buffered inserts; returns entries written (0 here --
        the in-memory cache has nothing to flush)."""
        return 0

    def close(self) -> None:
        """Release any backing resources (final flush for disk caches)."""


# --------------------------------------------------------------------------
# Disk-backed persistence.
# --------------------------------------------------------------------------
_SHARD_MAGIC = b"RPCC1\n"


class PersistentCostCache(CostMemoCache):
    """A :class:`CostMemoCache` whose entries survive restarts.

    Layout: ``cache_dir/<version>/shard-<pid>-<seq>.bin`` -- each shard is
    an immutable unit of fixed-width records ``[key bytes | 4 x f32 value]``
    behind a one-line JSON header, written through a tmp file and an atomic
    ``os.replace`` (a torn write leaves a ``.tmp`` orphan that loading
    ignores).  Opening reads every shard with one ``np.frombuffer`` each;
    corrupt or truncated shards are skipped and counted, never fatal.
    Writes are buffered and flushed every ``flush_every`` fresh entries, on
    :meth:`flush`, and on :meth:`close`.

    The version namespace (default :func:`model_version`) is the directory
    name, so a cost-model edit can never serve stale tuples: the new hash
    opens a different, initially empty directory.
    """

    def __init__(self, cache_dir: str, capacity: int = 2 ** 20,
                 version: Optional[str] = None, flush_every: int = 4096):
        super().__init__(capacity, version)
        if flush_every < 1:
            raise ValueError(f"flush_every must be >= 1, got {flush_every}")
        self.cache_dir = str(cache_dir)
        self._dir = os.path.join(self.cache_dir, self.version)
        os.makedirs(self._dir, exist_ok=True)
        self._flush_every = int(flush_every)
        self._io_lock = threading.Lock()
        self._pending: List[Tuple[bytes, np.ndarray]] = []
        self._seq = 0
        self.persisted = 0        # entries on disk (loaded + flushed)
        self.shards_loaded = 0
        self.corrupt_shards = 0
        self._load()

    # -- write-behind --------------------------------------------------------
    def _on_insert(self, fresh: List[Tuple[bytes, np.ndarray]]) -> None:
        with self._io_lock:
            self._pending.extend(
                (k, np.asarray(v, np.float32)) for k, v in fresh)
            due = len(self._pending) >= self._flush_every
        if due:
            self.flush()

    def flush(self) -> int:
        """Write buffered entries as one new shard per key width; atomic
        per shard (tmp + rename).  Returns the number of entries written."""
        with self._io_lock:
            pending, self._pending = self._pending, []
            if not pending:
                return 0
            by_len: Dict[int, list] = {}
            for k, v in pending:
                by_len.setdefault(len(k), []).append((k, v))
            for keylen, pairs in by_len.items():
                arr = np.empty((len(pairs), keylen + 16), np.uint8)
                for i, (k, v) in enumerate(pairs):
                    arr[i, :keylen] = np.frombuffer(k, np.uint8)
                    arr[i, keylen:] = np.frombuffer(
                        np.asarray(v, np.float32).tobytes(), np.uint8)
                head = _SHARD_MAGIC + json.dumps(
                    {"keylen": keylen, "count": len(pairs)}).encode() + b"\n"
                final = os.path.join(
                    self._dir, f"shard-{os.getpid()}-{self._seq:06d}.bin")
                self._seq += 1
                tmp = final + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(head)
                    f.write(arr.tobytes())
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, final)
            self.persisted += len(pending)
        return len(pending)

    def close(self) -> None:
        self.flush()

    # -- load ----------------------------------------------------------------
    def _load(self) -> None:
        names = sorted(n for n in os.listdir(self._dir)
                       if n.startswith("shard-") and n.endswith(".bin"))
        pre = self._vprefix
        for name in names:
            try:
                with open(os.path.join(self._dir, name), "rb") as f:
                    blob = f.read()
                if not blob.startswith(_SHARD_MAGIC):
                    raise ValueError("bad magic")
                nl = blob.index(b"\n", len(_SHARD_MAGIC))
                meta = json.loads(blob[len(_SHARD_MAGIC):nl])
                keylen, count = int(meta["keylen"]), int(meta["count"])
                width = keylen + 16
                body = np.frombuffer(blob, np.uint8, offset=nl + 1)
                if body.size < count * width:
                    raise ValueError("truncated shard")
                body = body[:count * width].reshape(count, width)
            except (ValueError, KeyError, OSError):
                # json.JSONDecodeError is a ValueError.
                self.corrupt_shards += 1
                continue
            vals = body[:, keylen:].copy().view(np.float32)
            with self._lock:
                for i in range(count):
                    k = pre + body[i, :keylen].tobytes()
                    self._data[k] = vals[i]
                    self._data.move_to_end(k)
                while len(self._data) > self.capacity:
                    self._data.popitem(last=False)
            self.shards_loaded += 1
            self.persisted += count
        # Continue shard numbering past what this PID may have left behind
        # in an earlier incarnation.
        tag = f"shard-{os.getpid()}-"
        seqs = [int(n[len(tag):-4]) for n in names if n.startswith(tag)]
        self._seq = max(seqs) + 1 if seqs else 0

    def stats(self) -> Dict[str, object]:
        s = super().stats()
        with self._io_lock:
            s.update({"persisted": self.persisted,
                      "pending_flush": len(self._pending),
                      "shards_loaded": self.shards_loaded,
                      "corrupt_shards": self.corrupt_shards,
                      "dir": self._dir})
        return s
