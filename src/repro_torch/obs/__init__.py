"""``repro_torch.obs``: zero-dependency observability for the serving and
engine stack of the port.

Port of ``repro.obs``.  Three pieces, one switch:

  * **metrics** -- a process-wide registry of counters / gauges / fixed-
    bucket histograms with Prometheus text exposition and a JSON snapshot
    (:mod:`repro_torch.obs.metrics`);
  * **tracing** -- nested spans with monotonic timestamps over a ring
    buffer, an optional JSONL sink, and a Chrome-trace/Perfetto export
    (:mod:`repro_torch.obs.trace`);
  * **flight recorder** -- a per-search accumulator whose summary lands in
    ``SearchOutcome.telemetry`` (:mod:`repro_torch.obs.recorder`).

Everything is off by default and observational by contract: enabling
telemetry never changes a search result (byte-identity is asserted across
the whole optimizer registry in tests/test_torch_conformance.py), the
disabled path costs one bool check per call site, and no instrumented
site reads a tensor on the card or synchronizes it: spans time the host's
wall clock and close after the synchronization the code already makes.
Metric and span names are the reference's (docs/observability.md); the
port's own spans and chunk counters are in docs/observability_torch.md.

Typical use::

    from repro_torch import api, obs

    obs.enable(trace=True)
    out = api.run_search(api.SearchRequest(workload="ncf", method="ga"))
    print(out.telemetry["hard_evals"], out.telemetry["cache_hit_rate"])
    obs.save_trace("trace.jsonl")          # or .json -> Chrome/Perfetto
    print(obs.REGISTRY.prometheus_text())
    obs.disable()
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs import state as _state
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                               MetricsRegistry, counter, gauge, histogram,
                               write_prometheus)
from repro_torch.obs.recorder import (FlightRecorder, current_recorder, record,
                                observe, recording)
from repro_torch.obs.trace import NULL_SPAN, Tracer, current, span
from repro_torch.obs import instrument

__all__ = [
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "gauge", "histogram", "write_prometheus",
    "FlightRecorder", "current_recorder", "record", "observe", "recording",
    "NULL_SPAN", "Tracer", "current", "span", "instrument",
    "enable", "disable", "enabled", "tracer", "save_trace", "reset",
]


def enable(trace: bool = True, ring: int = 16384,
           jsonl_path: Optional[str] = None) -> None:
    """Turn telemetry on process-wide.

    ``trace=True`` installs a :class:`Tracer` (``ring`` spans of in-memory
    history; ``jsonl_path`` additionally streams every finished span to a
    JSONL file).  Metrics and flight recorders activate either way.
    Idempotent: re-enabling with ``trace=True`` keeps an already-installed
    tracer unless a new ``jsonl_path`` is requested.
    """
    if trace:
        t = _state.tracer
        if t is None or jsonl_path is not None:
            if t is not None:
                t.close()
            _state.tracer = Tracer(ring=ring, jsonl_path=jsonl_path)
    _state.enabled = True


def disable() -> None:
    """Turn telemetry off (the default state); the tracer's buffered spans
    stay readable until :func:`enable` installs a fresh one."""
    _state.enabled = False


def enabled() -> bool:
    return _state.enabled


def tracer() -> Optional[Tracer]:
    return _state.tracer


def save_trace(path: str) -> None:
    """Write the installed tracer's ring buffer: ``.jsonl`` for one span per
    line, any other extension for Chrome-trace JSON (chrome://tracing or
    https://ui.perfetto.dev)."""
    t = _state.tracer
    if t is None:
        raise RuntimeError("no tracer installed; call obs.enable() first")
    t.save(path)


def reset() -> None:
    """Test/bench helper: zero metrics, clear spans and compile tracking."""
    REGISTRY.reset()
    instrument.reset_seen_programs()
    if _state.tracer is not None:
        _state.tracer.clear()
