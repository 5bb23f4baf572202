"""ConfuciuX-as-a-service: concurrent resource-assignment searches.

Port of ``repro.serving.search_service``, telemetry included, for the
methods the port has.  ``SearchService`` accepts any number of unified-API
:class:`~repro_torch.api.types.SearchRequest`\\ s and runs them on one
device:

  * every request runs on a worker-pool thread through the SAME registry
    adapters as ``api.run_search``, so outcomes are identical to serial
    runs;
  * the host-loop methods (``random``, ``grid``, ``bo``) route their genome
    evaluations through one shared
    :class:`~repro_torch.serving.batcher.CostEvalBatcher`, so N users'
    searches produce one fused dispatch stream and share the per-point
    :class:`~repro_torch.serving.cost_cache.CostMemoCache`;
  * ``ga``, ``sa`` and ``relaxed`` route each generation's / candidate's /
    round's hard fitness through the same batcher via a raw-array
    ``eval_fn``; ``nsga2`` does the same through a (b, 4)-costs variant
    of the hook (:meth:`CostEvalBatcher.evaluate_costs`), sharing the
    per-point cache entries with the scalar searches;
  * the RL family (``reinforce``, ``two_stage``, ``a2c``, ``ppo2``)
    interleaves at chunk granularity, streaming progress through the service's wrapper, which
    doubles as the cancellation point;
  * ``ticket.cancel()`` stops a search at its next progress chunk or next
    evaluation batch; a cancelled request never stalls the batcher.

The service runs on ``ServiceConfig.device`` (the CUDA card unless the
caller asks for the CPU): a request whose ``device`` differs fails its
ticket with a ``ValueError`` and runs nowhere else.

Typical use::

    from repro_torch import api
    from repro_torch.serving import SearchService

    with SearchService() as svc:
        tickets = [svc.submit(api.SearchRequest(workload="mobilenet_v2",
                                                eps=2000, method="random",
                                                seed=u))
                   for u in range(16)]
        outs = [t.result() for t in tickets]
        print(svc.stats()["cache_hit_rate"])
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api import registry as api_registry
from repro_torch.api import types as api_types
from repro_torch.core import env as env_lib
from repro_torch.costmodel.layers import layers_to_array
from repro_torch.obs import instrument as obs_instrument
from repro_torch.obs import state as obs_state
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.batcher import CostEvalBatcher
from repro_torch.serving.cost_cache import CostMemoCache, PersistentCostCache


class SearchCancelled(Exception):
    """Raised inside a worker when its ticket was cancelled mid-search."""


def _clone_exception(err: BaseException) -> BaseException:
    """Per-caller copy of a stored exception.

    ``raise`` assigns ``__traceback__`` on the raised object, so re-raising
    one shared instance from concurrent ``result()`` callers would let them
    mutate each other's tracebacks.  Each caller gets a fresh copy chained
    (``__cause__``) to the original; exceptions that defeat ``copy`` fall
    back to the shared instance.
    """
    try:
        clone = copy.copy(err)
    except Exception:  # noqa: BLE001 -- uncopyable exception type
        return err
    if clone is err:   # a __copy__ that returns self defeats the point
        return err
    clone.__traceback__ = None
    clone.__cause__ = err
    return clone


# Methods whose host-side eval loop accepts an injected genome-level
# ``eval_fn`` and can therefore be fused by the cross-request batcher.
BATCHED_METHODS = ("random", "grid", "bo")

# Chunked engines whose ``eval_fn`` takes already-decoded raw ``(pe, kt,
# df)`` arrays: GA populations, SA candidates and the relaxed engine's
# per-round hard probes route through the same batcher via
# :meth:`SearchService._make_raw_eval_fn`.  The RL family multiplexes at
# chunk granularity only.
RAW_BATCHED_METHODS = ("ga", "sa", "relaxed")

# Chunked multi-objective engines whose ``eval_fn(pe, kt, df)`` returns
# (b, 4) aggregated whole-model costs: NSGA-II populations fuse through the
# same batcher (a point evaluated for a scalar search is a cache hit for a
# frontier search and vice versa) via
# :meth:`SearchService._make_costs_eval_fn`.
COSTS_BATCHED_METHODS = ("nsga2",)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    max_workers: int = 8          # concurrent searches in flight
    cache_entries: int = 2 ** 20  # per-point memo capacity
    window_ms: float = 2.0        # batcher accumulation window
    device: str = "cuda"          # where every search and dispatch runs
    dispatch_workers: int = 1     # fused-dispatch pool size (batcher threads)
    # Methods whose (b, 4) costs go through the batcher; () keeps nsga2 on
    # its own per-request evaluation (the same bytes, no fusion or cache).
    costs_batched_methods: Tuple[str, ...] = COSTS_BATCHED_METHODS
    default_progress_every: int = 200   # service-side chunking when the
    #                                     request carries no callback
    cache_dir: Optional[str] = None     # persistent CostMemoCache root; the
    #                                     memo then survives restarts and is
    #                                     shared across processes
    cache_flush_every: int = 4096       # fresh entries buffered per shard


class SearchTicket:
    """Handle for one submitted search: result / progress / cancellation."""

    def __init__(self, uid: int, request: api_types.SearchRequest):
        self.uid = uid
        self.request = request
        self.status = "queued"     # queued|running|done|cancelled|failed
        self.trials: List[api_types.Trial] = []
        self.submitted_at = time.time()
        self.wall_seconds = 0.0
        self._outcome: Optional[api_types.SearchOutcome] = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        self._cancel = threading.Event()
        # Serializes the queued -> running claim against cancel()'s
        # queued -> cancelled claim, so exactly one side finishes a ticket
        # and a still-queued cancel completes immediately.
        self._state_lock = threading.Lock()
        self._started = False
        self._callbacks: List[Callable[["SearchTicket"], None]] = []

    # -- client side --------------------------------------------------------
    def cancel(self) -> None:
        """Request cancellation.

        A still-queued ticket finishes right here (status ``cancelled``,
        ``result()`` unblocked) and the worker pool later skips it.  A
        running ticket observes the flag at its next chunk or batch.
        """
        self._cancel.set()
        with self._state_lock:
            if self._started or self._done.is_set():
                return   # running (flag observed at next chunk) or finished
            callbacks = self._finish_locked(
                "cancelled",
                error=SearchCancelled(f"search {self.uid} cancelled"))
        for fn in callbacks:
            fn(self)

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None
               ) -> api_types.SearchOutcome:
        """Block for the outcome; raises SearchCancelled / the run's error."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"search {self.uid} still running")
        if self._error is not None:
            raise _clone_exception(self._error)
        return self._outcome

    def add_done_callback(self, fn: Callable[["SearchTicket"], None]) -> None:
        """Run ``fn(ticket)`` when the ticket finishes (immediately if it
        already has), on whichever thread finishes it; must not block."""
        with self._state_lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    # -- service side -------------------------------------------------------
    def _begin(self) -> bool:
        """Worker-side claim: queued -> running.  False when the ticket was
        already finished (cancelled while queued): the worker must skip."""
        with self._state_lock:
            if self._done.is_set():
                return False
            self._started = True
            self.status = "running"
            return True

    def _finish(self, status: str, outcome=None, error=None) -> bool:
        with self._state_lock:
            if self._done.is_set():
                return False
            callbacks = self._finish_locked(status, outcome, error)
        for fn in callbacks:
            fn(self)
        return True

    def _finish_locked(self, status: str, outcome=None, error=None) -> list:
        self.status = status
        self._outcome = outcome
        self._error = error
        self.wall_seconds = time.time() - self.submitted_at
        callbacks, self._callbacks = self._callbacks, []
        self._done.set()
        return callbacks


class SearchService:
    """Multiplexes concurrent SearchRequests onto one device."""

    def __init__(self, cfg: ServiceConfig = ServiceConfig()):
        self.cfg = cfg
        self.device = env_lib.resolve_device(cfg.device)
        if cfg.cache_dir:
            self.cache: CostMemoCache = PersistentCostCache(
                cfg.cache_dir, cfg.cache_entries,
                flush_every=cfg.cache_flush_every)
        else:
            self.cache = CostMemoCache(cfg.cache_entries)
        self.batcher = CostEvalBatcher(self.cache, window_ms=cfg.window_ms,
                                       device=self.device,
                                       dispatch_workers=cfg.dispatch_workers)
        self._pool = ThreadPoolExecutor(
            max_workers=cfg.max_workers, thread_name_prefix="search-worker")
        self._uids = itertools.count()
        self._lock = threading.Lock()
        self._counts = {"submitted": 0, "completed": 0, "cancelled": 0,
                        "failed": 0}
        # (layer bytes, EnvConfig) -> (layers, pe_table, kt_table, budget):
        # popular queries pay the budget's whole-model evaluation once.
        self._env_memo: Dict[tuple, tuple] = {}
        self._closed = False

    # -- public API ---------------------------------------------------------
    def submit(self, request: api_types.SearchRequest) -> SearchTicket:
        """Enqueue one search; returns immediately with a ticket."""
        ticket = SearchTicket(next(self._uids), request)
        # Check-and-submit under the lock: close() flips _closed under the
        # same lock before shutting the pool down, so a submit that passed
        # the check has handed its work to a live executor.
        with self._lock:
            if self._closed:
                raise RuntimeError("SearchService is closed")
            self._counts["submitted"] += 1
            try:
                self._pool.submit(self._run, ticket)
            except RuntimeError as e:   # the pool rejected it
                ticket._finish("failed", error=e)
                self._counts["failed"] += 1
                return ticket
        # Registered after release so a callback firing immediately never
        # re-enters self._lock while submit() holds it.
        ticket.add_done_callback(self._on_ticket_done)
        return ticket

    def run_all(self, requests: Sequence[api_types.SearchRequest]
                ) -> List[api_types.SearchOutcome]:
        """Submit a batch of requests and block for all outcomes (in order)."""
        tickets = [self.submit(r) for r in requests]
        return [t.result() for t in tickets]

    def stats(self) -> Dict[str, float]:
        with self._lock:
            s = dict(self._counts)
        b = self.batcher.stats()
        overlap = set(s) & set(b)
        if overlap:
            raise RuntimeError(f"service/batcher stats keys collide: "
                               f"{overlap}")
        s.update(b)
        return s

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self._pool.shutdown(wait=True)
        self.batcher.close()
        self.cache.close()   # final flush for persistent caches

    def __enter__(self) -> "SearchService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker -------------------------------------------------------------
    _STATUS_KEY = {"done": "completed", "cancelled": "cancelled",
                   "failed": "failed"}

    def _on_ticket_done(self, ticket: SearchTicket) -> None:
        """Single counting point for every way a ticket can finish --
        worker completion, worker error, and a queued cancel that never
        reaches a worker."""
        key = self._STATUS_KEY[ticket.status]
        if obs_state.enabled:
            obs_instrument.SERVICE_REQUESTS.inc(status=key)
        with self._lock:
            self._counts[key] += 1

    def _run(self, ticket: SearchTicket) -> None:
        if not ticket._begin():
            return   # cancelled while queued: already finished and counted
        obs_instrument.SERVICE_ACTIVE.inc()
        with obs_trace.span("service.search", uid=ticket.uid,
                            method=ticket.request.method) as sp:
            try:
                if ticket.cancelled:
                    raise SearchCancelled(f"search {ticket.uid} cancelled")
                dev = torch.device(ticket.request.device)
                if not _same_device(dev, self.device):
                    raise ValueError(
                        f"search {ticket.uid} asks for device {dev}, but "
                        f"this service runs on {self.device}")
                out = api_registry.run_search(self._instrument(ticket))
                ticket._finish("done", outcome=out)
            except SearchCancelled as e:
                ticket._finish("cancelled", error=e)
            except Exception as e:  # noqa: BLE001 -- reported via the ticket
                ticket._finish("failed", error=e)
            finally:
                obs_instrument.SERVICE_ACTIVE.dec()
            sp.set(status=self._STATUS_KEY[ticket.status])

    def _instrument(self, ticket: SearchTicket) -> api_types.SearchRequest:
        """Wrap the request with progress recording, cancellation and --
        for batchable methods -- the shared-batcher eval_fn."""
        request = ticket.request
        user_cb = request.on_progress

        def on_progress(trial: api_types.Trial) -> None:
            ticket.trials.append(trial)
            if ticket.cancelled:
                raise SearchCancelled(f"search {ticket.uid} cancelled")
            if user_cb is not None:
                user_cb(trial)

        progress_every = (request.progress_every if user_cb is not None
                          else self.cfg.default_progress_every)
        options = dict(request.options)
        method = api_registry.get_optimizer(request.method).name
        if method in BATCHED_METHODS:
            options["eval_fn"] = self._make_eval_fn(ticket)
        elif method in RAW_BATCHED_METHODS:
            options["eval_fn"] = self._make_raw_eval_fn(ticket)
        elif method in self.cfg.costs_batched_methods:
            options["eval_fn"] = self._make_costs_eval_fn(ticket)
        return dataclasses.replace(
            request, options=options, on_progress=on_progress,
            progress_every=progress_every)

    def _make_eval_fn(self, ticket: SearchTicket):
        """Drop-in for the baselines' built-in genome evaluation that
        routes through the shared batcher (decode stays exact: the same f32
        level tables the serial engine gathers from)."""
        request = ticket.request
        ecfg = request.env
        layers, pe_table, kt_table, budget = self._decode_tables(request)
        batcher = self.batcher

        def eval_fn(genomes):
            if ticket.cancelled:
                raise SearchCancelled(f"search {ticket.uid} cancelled")
            g = np.asarray(genomes)
            pe = pe_table[g[..., 0]]
            kt = kt_table[g[..., 1]]
            fit = batcher.evaluate(layers, pe, kt,
                                   np.float32(ecfg.dataflow), ecfg, budget)
            return fit, pe, kt

        return eval_fn

    def _make_raw_eval_fn(self, ticket: SearchTicket):
        """Raw-array eval hook for the chunked GA/SA/relaxed engines:
        ``eval_fn(pe, kt, df) -> (b,) fitness`` with already-decoded values.
        Every call doubles as a cancellation point."""
        request = ticket.request
        ecfg = request.env
        layers, _, _, budget = self._decode_tables(request)
        batcher = self.batcher

        def eval_fn(pe, kt, df):
            if ticket.cancelled:
                raise SearchCancelled(f"search {ticket.uid} cancelled")
            return batcher.evaluate(layers, pe, kt, df, ecfg, budget)

        return eval_fn

    def _make_costs_eval_fn(self, ticket: SearchTicket):
        """Raw-array eval hook for the multi-objective engines: the batcher
        routing of :meth:`_make_raw_eval_fn`, returning (b, 4) aggregated
        (lat, en, area, pw) costs -- what NSGA-II's constrained dominance
        ranks on.  Also the per-generation cancellation point."""
        request = ticket.request
        ecfg = request.env
        layers, _, _, budget = self._decode_tables(request)
        batcher = self.batcher

        def eval_fn(pe, kt, df):
            if ticket.cancelled:
                raise SearchCancelled(f"search {ticket.uid} cancelled")
            return batcher.evaluate_costs(layers, pe, kt, df, ecfg, budget)

        return eval_fn

    def _decode_tables(self, request: api_types.SearchRequest):
        """(layers, pe/kt tables, budget) for eval_fn decode, memoized per
        (workload, EnvConfig) so popular queries pay the platform budget's
        whole-model evaluation once."""
        wl = request.resolve_workload()
        arr = (layers_to_array(wl) if isinstance(wl, (list, tuple))
               else np.asarray(wl))
        key = (arr.astype(np.float32).tobytes(), request.env)
        with self._lock:
            hit = self._env_memo.get(key)
        if hit is not None:
            return hit
        env = env_lib.make_env(wl, request.env, self.device)
        entry = (env.layers.cpu().numpy(), env.pe_table.cpu().numpy(),
                 env.kt_table.cpu().numpy(),
                 np.float32(env.budget.cpu().numpy()))
        with self._lock:
            self._env_memo[key] = entry
        return entry
