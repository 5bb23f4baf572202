"""Cross-cutting instrumentation helpers + the port's metric catalog.

Port of ``repro.obs.instrument``.  Every instrumented module pulls its
metric handles from here so the full catalog lives in one place; each
metric name and span name of the reference is kept (docs/observability.md
documents them), so a dashboard or scraper built for the reference reads
the port unchanged; the port's own spans follow them
(docs/observability_torch.md).  All handles are created at import of this module --
creation is cheap and updates are no-ops while telemetry is disabled.

Also home of the compile tracker.  On the card the names read so:

  * ``repro_jit_compiles`` counts the first sighting of each
    ``(program, key)`` in the process.  That dispatch pays the one-time
    costs: loading the kernel extension and, when its build directory is
    cold, the ``nvcc`` build of its source.  Later dispatches with the
    same key run the loaded kernel.
  * The span ``xla.dispatch`` keeps its name and times one device
    dispatch on the host's wall clock: from the launch until the host
    sees its result (the caller's own synchronize, never one of the
    span's), so it is the device round trip.

``dispatch_span`` times every dispatch, tags the first sighting of a key
as ``compile=True``, and feeds both the per-search flight recorder and
the process-wide metrics.
"""
from __future__ import annotations

import threading
import time
from typing import Hashable, Tuple

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import recorder as _recorder
from repro_torch.obs import state as _state
from repro_torch.obs import trace as _trace

# --------------------------------------------------------------------------
# Metric catalog (names, types, labels).  docs/observability.md documents
# every entry; tests/test_torch_obs.py holds the names (and the help
# strings, byte for byte) to the reference's.
# --------------------------------------------------------------------------
SEARCH_HARD_EVALS = _metrics.counter(
    "repro_search_hard_evals", "Whole-model hard cost evaluations consumed",
    labels=("engine",))
SEARCH_CHUNKS = _metrics.counter(
    "repro_search_chunks", "Engine chunks executed", labels=("engine",))
SEARCH_CHUNK_SECONDS = _metrics.histogram(
    "repro_search_chunk_seconds", "Wall-clock per engine chunk",
    labels=("engine",))
JIT_COMPILES = _metrics.counter(
    "repro_jit_compiles", "First-dispatch (compile) events per XLA program",
    labels=("program",))
DISPATCH_SECONDS = _metrics.histogram(
    "repro_dispatch_seconds", "XLA/Pallas dispatch wall-clock",
    labels=("program",))

BATCHER_DISPATCHES = _metrics.counter(
    "repro_batcher_dispatches", "Fused-dispatch rounds executed")
BATCHER_POINTS = _metrics.counter(
    "repro_batcher_points", "Per-layer points through the batcher",
    labels=("kind",))   # kind: submitted|unique|fresh
BATCHER_QUEUE_DEPTH = _metrics.gauge(
    "repro_batcher_queue_depth", "Eval requests awaiting dispatch")
BATCHER_FUSE_WIDTH = _metrics.histogram(
    "repro_batcher_fuse_width", "Requests fused per dispatch",
    buckets=_metrics.DEFAULT_SIZE_BUCKETS)
BATCHER_QUEUE_WAIT = _metrics.histogram(
    "repro_batcher_queue_wait_seconds",
    "Submit-to-dispatch-start wait per eval request")
BATCHER_DISPATCH_SECONDS = _metrics.histogram(
    "repro_batcher_dispatch_seconds", "Fused dispatch wall-clock")

CACHE_LOOKUPS = _metrics.counter(
    "repro_cache_lookups", "Cost-memo lookups", labels=("result",))
CACHE_EVICTIONS = _metrics.counter(
    "repro_cache_evictions", "Cost-memo LRU evictions")
CACHE_LOOKUP_SECONDS = _metrics.histogram(
    "repro_cache_lookup_seconds", "Batched cache lookup latency")

SERVICE_ACTIVE = _metrics.gauge(
    "repro_service_active_searches", "Searches currently executing")
SERVICE_REQUESTS = _metrics.counter(
    "repro_service_requests", "Search tickets finished",
    labels=("status",))   # status: completed|cancelled|failed

HTTP_REQUESTS = _metrics.counter(
    "repro_http_requests", "HTTP front-door requests served",
    labels=("route", "code"))   # route is the template, not the raw path
HTTP_REQUEST_SECONDS = _metrics.histogram(
    "repro_http_request_seconds", "HTTP request handling wall-clock",
    labels=("route",))
HTTP_QUEUE_DEPTH = _metrics.gauge(
    "repro_http_queue_depth", "Front-door jobs awaiting a worker slot")

METRIC_NAMES = tuple(sorted(
    m.name for m in _metrics.REGISTRY.metrics()))

# Span taxonomy: the reference's names (docs/observability.md), then the
# port's own (docs/observability_torch.md).
SPAN_NAMES = (
    "service.search",     # one ticket end-to-end (uid, method, status)
    "search.run",         # one api.run_search call (method, eps, seed)
    "search.chunk",       # one engine chunk (engine, start, steps, evals)
    "batcher.dispatch",   # one fused dispatch (items, points, unique, fresh)
    "xla.dispatch",       # one device program dispatch (program, compile)
    "search.prepare",     # one piece of a search's set-up (part)
    "graph.capture",      # one CUDA-graph capture (warmup_us, launches)
)


# --------------------------------------------------------------------------
# JIT-compile tracking.
# --------------------------------------------------------------------------
_seen_lock = threading.Lock()
_seen_programs: set = set()


def first_dispatch(program: str, key: Hashable) -> bool:
    """True exactly once per (program, key) -- the compile-paying dispatch."""
    with _seen_lock:
        if (program, key) in _seen_programs:
            return False
        _seen_programs.add((program, key))
        return True


def reset_seen_programs() -> None:
    with _seen_lock:
        _seen_programs.clear()


class dispatch_span:
    """Time one device dispatch; tag and count its compile event.

    ``with dispatch_span("cost_eval", key=(kernel, Mp)):`` records an
    ``xla.dispatch`` span, a ``repro_dispatch_seconds`` observation and --
    on the first sighting of (program, key) -- a ``repro_jit_compiles``
    count plus ``jit_compiles`` in the current flight recorder.  Disabled
    telemetry reduces this to two perf_counter reads skipped entirely.
    """

    __slots__ = ("program", "key", "_span", "_t0", "_compile")

    def __init__(self, program: str, key: Hashable = ()):
        self.program = program
        self.key = key

    def __enter__(self):
        if not _state.enabled:
            self._t0 = None
            return self
        self._compile = first_dispatch(self.program, self.key)
        self._span = _trace.span("xla.dispatch", program=self.program,
                                 compile=self._compile).__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is None:
            return False
        dt = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        DISPATCH_SECONDS.observe(dt, program=self.program)
        if self._compile:
            JIT_COMPILES.inc(program=self.program)
            _recorder.record("jit_compiles")
        _recorder.observe(f"{self.program}_dispatch_s", dt)
        return False


def chunk_metrics(engine: str, steps: int, evals: int,
                  seconds: float) -> None:
    """One chunk finished: registry counters + flight-recorder entries."""
    SEARCH_CHUNKS.inc(engine=engine)
    SEARCH_HARD_EVALS.inc(evals, engine=engine)
    SEARCH_CHUNK_SECONDS.observe(seconds, engine=engine)
    _recorder.record("chunks")
    _recorder.record("hard_evals", evals)
    _recorder.observe("chunk_s", seconds)


def hard_evals(engine: str, n: int) -> None:
    """Count ``n`` hard evaluations outside the chunk loop (the host-batch
    baselines -- random/grid/bo -- burn their budget in plain batched loops).
    Self-gated: free while telemetry is off."""
    if not _state.enabled:
        return
    SEARCH_HARD_EVALS.inc(n, engine=engine)
    _recorder.record("hard_evals", n)
