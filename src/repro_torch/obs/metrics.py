"""Process-wide metrics registry: counters, gauges, histograms.

Port of ``repro.obs.metrics``, byte for byte in its exposition: the same
names, label sets, bucket edges and ``_total`` suffixes.  Zero-dependency
Prometheus-style metrics shared by the serving stack and the search
engines.  A metric is created once (``REGISTRY.counter(...)`` is
get-or-create and idempotent) and updated from any thread; every update
is gated on :mod:`repro_torch.obs.state` so a disabled process pays one
bool check per call site.

Two export formats:

  * :meth:`MetricsRegistry.prometheus_text` -- the Prometheus text
    exposition format (``# HELP`` / ``# TYPE`` comments, cumulative
    ``_bucket{le=...}`` histogram samples), scrapable or checkable with
    ``tools/check_telemetry.py``;
  * :meth:`MetricsRegistry.snapshot` -- a JSON-safe nested dict, the form
    benchmarks stamp into ``results/*.json``.

Histograms use *fixed* bucket edges chosen at creation so concurrent
observations never reshape the layout (thread-safe by construction) and
text exposition stays stable across runs.
"""
from __future__ import annotations

import bisect
import threading
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.obs import state as _state

# Default edges span the latencies this repo actually sees: microsecond
# cache lookups up to multi-second fused dispatches / search chunks.
DEFAULT_TIME_BUCKETS = (1e-5, 1e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5,
                        1.0, 5.0, 30.0)
# Size-ish quantities: fuse widths, batch sizes, queue depths.
DEFAULT_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                        256.0, 1024.0, 4096.0)


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def _fmt_labels(names: Sequence[str], values: Sequence[str],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Metric:
    """Shared plumbing: label handling, per-metric lock, registration."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._values: "OrderedDict[Tuple[str, ...], object]" = OrderedDict()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.label_names)}")
        return tuple(str(labels[n]) for n in self.label_names)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()


class Counter(_Metric):
    """Monotonically increasing count (exposed with a ``_total`` name)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not _state.enabled:
            return
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(self._key(labels), 0.0))

    def _samples(self):
        with self._lock:
            return [(f"{self.name}_total", self.label_names, k, (), v)
                    for k, v in self._values.items()]

    def _snap(self):
        with self._lock:
            return {",".join(k) or "": v for k, v in self._values.items()}


class Gauge(_Metric):
    """Point-in-time value that can go up and down."""

    kind = "gauge"

    def _samples(self):
        with self._lock:
            return [(self.name, self.label_names, k, (), v)
                    for k, v in self._values.items()]

    def set(self, value: float, **labels) -> None:
        if not _state.enabled:
            return
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not _state.enabled:
            return
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._values.get(self._key(labels), 0.0))

    _snap = Counter._snap


class Histogram(_Metric):
    """Fixed-bucket histogram: cumulative ``le`` buckets + sum + count.

    The bucket edges are frozen at creation; an implicit ``+Inf`` bucket
    catches the tail.  Per-label-set storage is ``[counts..., sum, count,
    max]`` -- ``max`` is not part of the Prometheus exposition but rides in
    :meth:`MetricsRegistry.snapshot` because flight-recorder style "worst
    observed" questions come up constantly in search profiling.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 label_names: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, help, label_names)
        edges = tuple(sorted(float(b) for b in buckets))
        if not edges:
            raise ValueError(f"{name}: need at least one bucket edge")
        self.buckets = edges

    def observe(self, value: float, **labels) -> None:
        if not _state.enabled:
            return
        key = self._key(labels)
        value = float(value)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            row = self._values.get(key)
            if row is None:
                row = self._values[key] = (
                    [0] * (len(self.buckets) + 1) + [0.0, 0, value])
            row[i] += 1
            row[-3] += value
            row[-2] += 1
            row[-1] = max(row[-1], value)

    def stats(self, **labels) -> Dict[str, float]:
        """(sum, count, mean, max) for one label set -- test/report helper."""
        with self._lock:
            row = self._values.get(self._key(labels))
            if row is None:
                return {"sum": 0.0, "count": 0, "mean": 0.0, "max": 0.0}
            return {"sum": row[-3], "count": row[-2],
                    "mean": row[-3] / max(row[-2], 1), "max": row[-1]}

    def _samples(self):
        out = []
        with self._lock:
            for k, row in self._values.items():
                cum = 0
                for edge, n in zip(self.buckets, row[:-3]):
                    cum += n
                    out.append((f"{self.name}_bucket", self.label_names, k,
                                (("le", repr(float(edge))),), cum))
                out.append((f"{self.name}_bucket", self.label_names, k,
                            (("le", "+Inf"),), cum + row[-4]))
                out.append((f"{self.name}_sum", self.label_names, k, (),
                            row[-3]))
                out.append((f"{self.name}_count", self.label_names, k, (),
                            row[-2]))
        return out

    def _snap(self):
        with self._lock:
            return {
                ",".join(k) or "": {
                    "buckets": dict(zip([repr(float(b))
                                         for b in self.buckets] + ["+Inf"],
                                        row[:-3])),
                    "sum": row[-3], "count": row[-2], "max": row[-1],
                }
                for k, row in self._values.items()}


class MetricsRegistry:
    """Name -> metric map with get-or-create semantics and two exporters."""

    def __init__(self):
        self._metrics: "OrderedDict[str, _Metric]" = OrderedDict()
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labels, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.label_names}")
                return m
            m = cls(name, help, labels, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def metrics(self):
        with self._lock:
            return list(self._metrics.values())

    def reset(self) -> None:
        """Zero every metric's values (definitions stay registered)."""
        for m in self.metrics():
            m.clear()

    def prometheus_text(self) -> str:
        """The Prometheus text exposition format, terminated by a newline."""
        lines = []
        for m in self.metrics():
            lines.append(f"# HELP {m.name} {_escape(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for name, lnames, lvals, extra, v in m._samples():
                val = repr(float(v)) if isinstance(v, float) else str(v)
                lines.append(f"{name}{_fmt_labels(lnames, lvals, extra)} "
                             f"{val}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, dict]:
        """JSON-safe ``{name: {kind, labels, values}}`` dump."""
        return {m.name: {"kind": m.kind, "help": m.help,
                         "labels": list(m.label_names), "values": m._snap()}
                for m in self.metrics()}


# The process-wide default registry every instrumented module shares.
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "",
            labels: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_TIME_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labels, buckets)


def write_prometheus(path: str,
                     registry: Optional[MetricsRegistry] = None) -> None:
    """Write the exposition text (or a JSON snapshot for ``.json`` paths)."""
    import json
    import os

    reg = registry if registry is not None else REGISTRY
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        if path.endswith(".json"):
            json.dump(reg.snapshot(), f, indent=1)
        else:
            f.write(reg.prometheus_text())
