"""Canonical request/outcome schema shared by every search method.

Port of ``repro.api.types``.  One ``SearchRequest`` describes a search
independently of the optimizer that runs it, plus the ``device`` it runs
on (the CUDA card unless the caller asks for the CPU); one
``SearchOutcome`` reports the result in the same shape for every method.

Sample accounting: ``eps`` counts whole-model evaluations -- one RL
episode, one GA individual each cost exactly one sample.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np

from repro_torch.core import env as env_lib
from repro_torch.costmodel import workloads as workloads_lib


class Trial(NamedTuple):
    """One streamed progress report from a running optimizer.

    ``step`` is the number of samples (whole-model evaluations) consumed so
    far; ``value`` the best objective inside the reported span; ``best_value``
    the best-so-far across the whole run (inf until a feasible point shows).

    ``shard`` tags multi-worker streams: the ``fanout`` optimizer merges its
    shards' live traces into one callback and stamps each chunk with the
    shard index it came from (``best_value`` is then the *ensemble*
    best-so-far).  Single-worker optimizers leave it None; ``step`` stays
    monotone per shard, not across the interleaved merged stream.
    """

    step: int
    value: float
    best_value: float
    shard: Optional[int] = None


ProgressFn = Callable[[Trial], None]


@dataclasses.dataclass
class SearchRequest:
    """Method-agnostic description of one resource-assignment search.

    workload: a paper workload name (str), a list of LayerSpec, or an
        (N, NUM_FIELDS) layer array.
    env:     the environment config (objective/constraint/platform/dataflow).
    eps:     sample budget in whole-model evaluations (paper: 5000).
    seed:    RNG seed threaded to whichever method runs.
    method:  registry name used by :func:`repro_torch.api.run_search`.
    options: method-specific knobs; adapters ignore what they do not know.
    on_progress / progress_every: optional streaming hook.  ``fanout``
        merges all of its shards into this one hook, tagging each Trial
        with its shard index.
    device:  where the search runs: "cuda" (default) or "cpu".  A CUDA
        request without a card raises; nothing falls back to the CPU.
    """

    workload: Any
    env: env_lib.EnvConfig = dataclasses.field(
        default_factory=env_lib.EnvConfig)
    eps: int = 5000
    seed: int = 0
    method: str = "two_stage"
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    on_progress: Optional[ProgressFn] = None
    progress_every: int = 100
    device: str = "cuda"

    def __post_init__(self):
        if self.eps < 1:
            raise ValueError(f"eps must be >= 1, got {self.eps}")

    def resolve_workload(self):
        if isinstance(self.workload, str):
            return workloads_lib.get_workload(self.workload)
        return self.workload

    @property
    def num_layers(self) -> int:
        wl = self.resolve_workload()
        if isinstance(wl, (list, tuple)):
            return len(wl)
        return int(np.asarray(wl).shape[0])


@dataclasses.dataclass
class SearchOutcome:
    """Unified search result: every registered optimizer returns this.

    history is the best-so-far objective per sample: length == eps, monotone
    non-increasing, +inf while nothing feasible has been seen (the paper's
    "NAN").  pe/kt/df are the per-layer raw assignment of the best solution
    (NaN-filled when the method never found a feasible point).

    frontier is set by the multi-objective engines only (``nsga2``): the
    final Pareto frontier of feasible designs as a dict of arrays sorted
    by latency -- ``lat``/``en``/``area``/``pw`` of shape (F,) plus the
    realizing per-layer ``pe``/``kt``/``df`` of shape (F, N); no point
    dominates another on (lat, en) and each fits the platform budget.
    Chunk-by-chunk snapshots ride in ``extras["frontier_trace"]`` (a list
    of (F_i, 4) cost arrays).

    telemetry is the search's flight-recorder summary (hard evals, chunks,
    cache hit rate, queue-wait / dispatch / device timings, first
    dispatches) -- filled by :func:`repro_torch.api.run_search` when
    :mod:`repro_torch.obs` telemetry is on, None otherwise.  Purely
    observational: the same search with telemetry on and off returns
    byte-identical results everywhere else.
    """

    method: str
    best_value: float
    pe: np.ndarray
    kt: np.ndarray
    df: np.ndarray
    history: np.ndarray
    eps: int
    seed: int
    samples_to_convergence: int
    wall_seconds: float
    feasible: bool
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)
    frontier: Optional[Dict[str, np.ndarray]] = None
    telemetry: Optional[Dict[str, Any]] = None

    def summary(self) -> str:
        """A human-readable report of the run."""
        lines = [
            f"method={self.method}  seed={self.seed}  eps={self.eps}",
            (f"best_value={self.best_value:.6g}  "
             f"feasible={self.feasible}  "
             f"converged@{self.samples_to_convergence}  "
             f"wall={self.wall_seconds:.2f}s"),
        ]
        if self.feasible:
            lines.append(
                f"assignment: pe={np.asarray(self.pe).tolist()} "
                f"kt={np.asarray(self.kt).tolist()} "
                f"df={np.asarray(self.df).tolist()}")
        if self.frontier is not None:
            lines.append(f"frontier: {len(self.frontier['lat'])} "
                         "non-dominated feasible designs")
        t = self.telemetry
        if t:
            bits = []
            if "hard_evals" in t:
                bits.append(f"hard_evals={int(t['hard_evals'])}")
            if "chunks" in t:
                bits.append(f"chunks={int(t['chunks'])}")
            if "cache_hit_rate" in t:
                bits.append(f"cache_hit_rate={t['cache_hit_rate']:.2%}")
            if "jit_compiles" in t:
                bits.append(f"jit_compiles={int(t['jit_compiles'])}")
            for key, label in (("queue_wait_s", "queue_wait"),
                               ("dispatch_s", "dispatch"),
                               ("device_s", "device")):
                s = t.get(key)
                if isinstance(s, dict):
                    bits.append(f"{label}={s['sum']:.3f}s")
            if bits:
                lines.append("telemetry: " + "  ".join(bits))
        return "\n".join(lines)


def samples_to_convergence(trace: np.ndarray, tol: float = 0.05) -> int:
    """First sample index (1-based) within ``tol`` of the final best value."""
    trace = np.asarray(trace, dtype=float)
    finite = np.isfinite(trace)
    if not finite.any():
        return len(trace)
    final = trace[finite][-1]
    ok = finite & (trace <= final * (1 + tol))
    return int(np.argmax(ok)) + 1 if ok.any() else len(trace)


def expand_trace(per_span_best, span: int) -> np.ndarray:
    """Expand a per-generation/per-epoch best-so-far trace to per-sample.

    A span's best is credited to the span's *last* sample; earlier samples
    inherit the previous span's best (inf for the first span).
    """
    per_span_best = np.asarray(per_span_best, dtype=float).ravel()
    if span <= 1:
        return per_span_best
    t = np.full(len(per_span_best) * span, np.inf)
    t[span - 1::span] = per_span_best
    return np.minimum.accumulate(t)


def fit_trace(trace, eps: int) -> np.ndarray:
    """Normalize a raw trace to the outcome schema: (eps,) monotone best-so-
    far, padded with its last value / truncated as needed."""
    tr = np.asarray(trace, dtype=float).ravel()
    if tr.size == 0:
        tr = np.array([np.inf])
    tr = np.minimum.accumulate(tr)
    if len(tr) >= eps:
        return tr[:eps]
    return np.concatenate([tr, np.full(eps - len(tr), tr[-1])])


def build_outcome(request: SearchRequest, method: str, best_value, pe, kt,
                  df, trace, t0: float, extras=None,
                  streamed: bool = False,
                  frontier=None) -> SearchOutcome:
    """Normalize a finished run into the unified schema.

    ``pe``/``kt`` may be None (nothing feasible found -> NaN-filled arrays);
    ``df`` may be None (fixed-dataflow method -> the env's dataflow id).
    ``frontier`` is the Pareto-frontier dict of a multi-objective engine.
    """
    best_value = float(best_value)
    N = request.num_layers
    if pe is None or kt is None:
        pe = np.full((N,), np.nan)
        kt = np.full((N,), np.nan)
    if df is None:
        df = np.full((N,), request.env.dataflow, np.int32)
    history = fit_trace(trace, request.eps)
    if not streamed:
        emit_trace(request, history)
    return SearchOutcome(
        method=method, best_value=best_value,
        pe=np.asarray(pe), kt=np.asarray(kt),
        df=np.broadcast_to(np.asarray(df), (N,)).copy(),
        history=history, eps=request.eps, seed=request.seed,
        samples_to_convergence=samples_to_convergence(history),
        wall_seconds=time.time() - t0,
        feasible=bool(np.isfinite(best_value)),
        extras=dict(extras or {}), frontier=frontier)


def emit_trace(request: SearchRequest, history: np.ndarray) -> None:
    """Fire the request's progress callback over a finished trace at
    ``progress_every`` granularity."""
    cb = request.on_progress
    if cb is None:
        return
    n = len(history)
    every = max(int(request.progress_every), 1)
    last = 0
    for step in range(every, n + 1, every):
        cb(Trial(step, float(history[step - 1]), float(history[step - 1])))
        last = step
    if last < n:
        cb(Trial(n, float(history[-1]), float(history[-1])))
