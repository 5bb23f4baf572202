"""Structured tracing: nested spans over a ring buffer, JSONL + Chrome export.

Port of ``repro.obs.trace``. A *span* is one named, timed region with
attributes -- ``batcher.dispatch``, ``search.chunk``, ``xla.dispatch`` --
recorded with monotonic ``time.perf_counter_ns`` timestamps so durations
are immune to wall-clock jumps. Spans nest per thread (a thread-local stack
tracks depth and parent) and land in:

  * an in-memory ring buffer (``collections.deque(maxlen=...)`` -- bounded,
    allocation-cheap, safe to leave on for long service runs);
  * optionally a JSONL trace file, one JSON object per finished span,
    appended under a lock (multi-thread safe);
  * on demand, a Chrome-trace JSON export loadable in ``chrome://tracing``
    or https://ui.perfetto.dev (``ph: "X"`` complete events).

Recording is observational only: spans never touch RNG state, search state
or any value the engines compute.  When tracing is disabled, ``span()``
returns one shared null context manager -- no allocation, no clock read.

Beyond the reference: :func:`current` hands an engine the innermost open
span of its thread, so it can attach counters to the ``search.chunk``
span the chunk loop opened around it; and while a ``torch.profiler``
records, each span is mirrored into the profiler's trace as a
``record_function`` range of the same name, so the profiler's host
timeline shows the program's layers beside the aten ops.  A span's
``ts_us`` is on the wall clock (a ``perf_counter_ns`` reading moved by an
anchor the :class:`Tracer` takes when it is created), the clock the
profiler's events are on.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

from repro_torch.obs import state as _state


class _NullSpan:
    """Shared do-nothing span: the disabled path and attr sink."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _Span:
    """One live span; finished records are plain dicts in the ring."""

    __slots__ = ("tracer", "name", "attrs", "t0", "parent", "depth", "tid",
                 "_mirror")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> "_Span":
        """Attach attributes discovered mid-span (e.g. fuse width)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        tls = self.tracer._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        self.parent = stack[-1].name if stack else None
        self.depth = len(stack)
        self.tid = threading.get_ident()
        stack.append(self)
        # The profiler's flag is a module attribute it sets on start and
        # clears on stop: one test while no profiler records.
        self._mirror = None
        if _profiler._is_profiler_enabled:
            self._mirror = _profiler.record_function(self.name)
            self._mirror.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        if self._mirror is not None:
            self._mirror.__exit__(*exc)
        stack = self.tracer._tls.stack
        if stack and stack[-1] is self:
            stack.pop()
        self.tracer._record(self, dur)
        return False


class Tracer:
    """Span collector: ring buffer + optional JSONL sink + exporters."""

    def __init__(self, ring: int = 16384,
                 jsonl_path: Optional[str] = None):
        self._ring: "deque[dict]" = deque(maxlen=max(int(ring), 1))
        self._tls = threading.local()
        self._lock = threading.Lock()
        self._jsonl_path = jsonl_path
        self._jsonl_file = None
        self.dropped = 0
        # The wall-clock anchor of this tracer's timestamps, taken now
        # (not at import), so a long-lived process still agrees with the
        # profiler's clock after the wall clock was stepped.
        self._t0_ns = time.perf_counter_ns()
        self._epoch_us = time.time_ns() / 1e3
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)
            self._jsonl_file = open(jsonl_path, "w")

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def _record(self, span: _Span, dur_ns: int) -> None:
        rec = {
            "name": span.name,
            "ts_us": round((span.t0 - self._t0_ns) / 1e3 + self._epoch_us,
                           3),
            "dur_us": round(dur_ns / 1e3, 3),
            "tid": span.tid,
            "depth": span.depth,
        }
        if span.parent is not None:
            rec["parent"] = span.parent
        if span.attrs:
            rec["attrs"] = {k: _jsonable(v) for k, v in span.attrs.items()}
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)
            if self._jsonl_file is not None:
                self._jsonl_file.write(json.dumps(rec) + "\n")
                self._jsonl_file.flush()

    def current(self):
        """The innermost span open on this thread, or :data:`NULL_SPAN`."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else NULL_SPAN

    def spans(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    # -- exporters ----------------------------------------------------------
    def chrome_trace(self) -> Dict:
        """Chrome trace-event JSON (complete events, microsecond units)."""
        pid = os.getpid()
        events = [{
            "name": rec["name"],
            "ph": "X",
            "ts": rec["ts_us"],
            "dur": rec["dur_us"],
            "pid": pid,
            "tid": rec["tid"],
            "args": rec.get("attrs", {}),
        } for rec in self.spans()]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        """Write the ring buffer: ``.jsonl`` -> one span per line; anything
        else -> Chrome trace JSON (open in chrome://tracing or Perfetto)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            if path.endswith(".jsonl"):
                for rec in self.spans():
                    f.write(json.dumps(rec) + "\n")
            else:
                json.dump(self.chrome_trace(), f)

    def close(self) -> None:
        with self._lock:
            if self._jsonl_file is not None:
                self._jsonl_file.close()
                self._jsonl_file = None


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


def span(name: str, **attrs):
    """The module-level span entry point every call site uses.

    Disabled (no tracer or telemetry off) -> the shared :data:`NULL_SPAN`;
    enabled -> a real span on the installed tracer.  Always usable as
    ``with obs.span("x", k=v) as sp: sp.set(more=...)``.
    """
    tracer = _state.tracer
    if tracer is None or not _state.enabled:
        return NULL_SPAN
    return tracer.span(name, **attrs)


def current():
    """The innermost span open on this thread, to attach counters to
    (``current().set(k=v)``); the shared :data:`NULL_SPAN`, whose ``set``
    does nothing, when telemetry is off or no span is open."""
    tracer = _state.tracer
    if tracer is None or not _state.enabled:
        return NULL_SPAN
    return tracer.current()


@contextlib.contextmanager
def timed(out: dict, key: str):
    """Tiny helper: time a block into ``out[key]`` (seconds) -- used where a
    duration is needed even without a tracer installed."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        out[key] = time.perf_counter() - t0
