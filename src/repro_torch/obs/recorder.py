"""Per-search flight recorder: one search's telemetry, attached to its outcome.

Port of ``repro.obs.recorder``. A :class:`FlightRecorder` rides along one
search from submission to ``SearchOutcome``: the shared chunk loop counts
hard evaluations and chunk timings into it, the cost-eval batcher
attributes queue-wait / dispatch / device time and cache hits to it (the
recorder is captured at submit time, so a dispatch fused across N searches
credits each rider its own share), and the compile tracker notes
first-dispatch events. The final :meth:`summary` dict lands in
``SearchOutcome.telemetry``.

Attribution across threads: the *search worker* thread installs its
recorder with :func:`recording` (a plain ``threading.local`` -- each
concurrent search in a ``SearchService`` worker pool sees only its own),
and hands it to the batcher inside the submitted item, so the dispatcher
threads write to the right recorder without any global coordination.
Recorders are lock-protected; everything they store is observational.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

from repro_torch.obs import state as _state

_tls = threading.local()


class FlightRecorder:
    """Thread-safe accumulator of one search's counters and timings.

    ``add`` accumulates plain counts (hard evals, points, cache hits);
    ``observe`` accumulates (sum, count, max) timing/size series -- enough
    to report totals, means and worst cases without storing every sample.
    """

    __slots__ = ("engine", "_lock", "_counts", "_series")

    def __init__(self, engine: Optional[str] = None):
        self.engine = engine
        self._lock = threading.Lock()
        self._counts: Dict[str, float] = {}
        self._series: Dict[str, list] = {}   # key -> [sum, count, max]

    def add(self, key: str, n: float = 1.0) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0.0) + n

    def observe(self, key: str, value: float) -> None:
        value = float(value)
        with self._lock:
            row = self._series.get(key)
            if row is None:
                self._series[key] = [value, 1, value]
            else:
                row[0] += value
                row[1] += 1
                row[2] = max(row[2], value)

    def count(self, key: str) -> float:
        with self._lock:
            return self._counts.get(key, 0.0)

    def summary(self) -> Dict[str, object]:
        """One JSON-safe dict: raw counts, per-series (sum, mean, max), and
        the derived ratios everyone asks for first (cache hit rate, dedup).
        """
        with self._lock:
            counts = dict(self._counts)
            series = {k: list(v) for k, v in self._series.items()}
        out: Dict[str, object] = {"engine": self.engine}
        for k, v in sorted(counts.items()):
            out[k] = int(v) if float(v).is_integer() else v
        for k, (s, n, mx) in sorted(series.items()):
            out[k] = {"sum": round(s, 6), "count": n,
                      "mean": round(s / max(n, 1), 6), "max": round(mx, 6)}
        points = counts.get("points", 0.0)
        if points:
            out["cache_hit_rate"] = round(
                counts.get("cached_points", 0.0) / points, 4)
            out["fresh_frac"] = round(
                counts.get("fresh_points", 0.0) / points, 4)
        return out


def current_recorder() -> Optional[FlightRecorder]:
    """This thread's active recorder, or None outside a recorded search."""
    return getattr(_tls, "recorder", None)


@contextlib.contextmanager
def recording(rec: Optional[FlightRecorder]):
    """Install ``rec`` as this thread's recorder for the duration."""
    prev = getattr(_tls, "recorder", None)
    _tls.recorder = rec
    try:
        yield rec
    finally:
        _tls.recorder = prev


def record(key: str, n: float = 1.0) -> None:
    """Count ``n`` into the current recorder (no-op when none/disabled)."""
    if not _state.enabled:
        return
    rec = getattr(_tls, "recorder", None)
    if rec is not None:
        rec.add(key, n)


def observe(key: str, value: float) -> None:
    """Observe a timing/size into the current recorder (no-op otherwise)."""
    if not _state.enabled:
        return
    rec = getattr(_tls, "recorder", None)
    if rec is not None:
        rec.observe(key, value)
