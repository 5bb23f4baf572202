"""Cross-request cost-eval batcher: one dispatch stream for N searches.

Port of ``repro.serving.batcher``, telemetry included.  Concurrent
searches running on worker threads each hand it batches of genome
evaluations (random/grid/bo through their ``eval_fn``, GA populations and
SA candidates through their raw ``eval_fn``, NSGA-II populations through
:meth:`CostEvalBatcher.evaluate_costs`).  Dispatcher threads take
everything pending and:

  1. flatten every pending item into per-layer *points* ``(layer fields,
     pe, kt, df)`` -- the cost model is per point, so points from
     different workloads concatenate freely;
  2. dedupe identical points across and within items with one
     ``np.unique`` pass over the rows' bytes;
  3. look the unique points up in the
     :class:`~repro_torch.serving.cost_cache.CostMemoCache` and evaluate
     only the fresh ones in ONE call of the per-row cost kernel
     (:func:`eval_point_rows`: one upload of their packed rows, one launch
     that reads them in place and writes each point's four costs as one
     row, one download; its plain version when the batcher runs on the
     CPU);
  4. reassemble each item's values to the ``(b, N)`` shape the serial
     engine reduces over and aggregate them with the serial engine's own
     :func:`repro_torch.core.env.aggregate_costs` (``(b,)`` fitness), or
     :func:`~repro_torch.core.env.stacked_costs_multi` for a costs item
     (``(b, 4)`` whole-model costs), on the batcher's device
     (:func:`aggregate_items`: one upload and one download for all items).
     Scalar and costs items share the cache's per-point entries: a point
     is the same row either way.

On a card each dispatcher thread has a CUDA stream of its own and pinned
host buffers (:class:`_DeviceIO`), and a dispatch waits on that stream
alone, not behind the work the searches queue on the card: one host sync
for a dispatch whose points are all cached, two for one with fresh points.

Exactness, by construction: the per-row kernel and the single-table kernel
the serial engines launch share one ``core_cost`` device function built
with one set of flags (on the CPU both plain versions run the same
``maestro.core_cost``), so a point's four values are the same bits in any
batch; and the reduction runs over (b, N) tensors laid out as the
single-table kernel lays out its own output (one (4, b, N) block), with
the budget as the same float32 value.  So a search through the batcher
returns bit-identical fitness to the same search run serially, cache hits
and cross-request fusion included.

Telemetry (:mod:`repro_torch.obs`, off by default) is observational: the
queue-depth gauge, one ``batcher.dispatch`` span per dispatch, the
submitted / unique / fresh point counters, and per-rider flight-recorder
credit (each item carries the recorder of the search that submitted it).
The per-row launch sits in a ``dispatch_span`` that closes after the
stream's own synchronize, so it times the device round trip and adds no
sync, no device read and no other stream.

The batcher evaluates on one device: ``device="cuda"`` (the default) needs
a card and raises without one; on a CUDA device the per-row kernel runs or
the dispatch fails, and nothing falls back to the CPU.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import env as env_lib
from repro_torch.costmodel.layers import NUM_FIELDS
from repro_torch.kernels import ops
from repro_torch.obs import instrument as obs_instrument
from repro_torch.obs import recorder as obs_recorder
from repro_torch.obs import state as obs_state
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.cost_cache import CostMemoCache

_PE_COL = NUM_FIELDS
_KT_COL = NUM_FIELDS + 1
_DF_COL = NUM_FIELDS + 2
ROW_WIDTH = NUM_FIELDS + 3   # layer fields + pe + kt + df
_ROW_BYTES = np.dtype((np.void, 4 * ROW_WIDTH))   # one packed row, opaque


class _Item:
    """One in-flight eval request: points + how to aggregate them."""

    __slots__ = ("points", "shape", "ecfg", "budget", "multi", "event",
                 "fit", "error", "recorder", "t_enqueue")

    def __init__(self, points, shape, ecfg, budget, multi=False):
        self.points = points          # (b*N, ROW_WIDTH) f32
        self.shape = shape            # (b, N)
        self.ecfg = ecfg              # the request's EnvConfig
        self.budget = budget          # np.float32
        self.multi = multi            # (b, 4) aggregated costs, not (b,) fit
        self.event = threading.Event()
        self.fit: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        # Telemetry attribution: the submitting search's flight recorder is
        # captured at submit time (on the search worker's thread), so the
        # dispatcher thread credits queue-wait / fuse / cache stats to the
        # right search even when one dispatch fuses N searches' requests.
        self.recorder = None
        self.t_enqueue = 0.0


class CostEvalBatcher:
    """Fuses concurrent searches' cost evaluations into single dispatches.

    ``window_ms`` is the accumulation window after the first pending item;
    while a dispatch executes, new arrivals queue up, so fusion widths
    track the number of concurrently evaluating searches.  ``device`` is
    where points are evaluated and aggregated.

    ``dispatch_workers`` sizes the dispatch pool: with N > 1, up to N fused
    dispatches run at once (the kernel launch and the copies release the
    GIL).  Fusion grouping never changes values -- the cost model is
    elementwise per point and each item aggregates only its own points --
    so pooled dispatch stays bit-identical to one dispatcher, cache races
    included (two workers evaluating the same point store the same bytes).
    """

    def __init__(self, cache: Optional[CostMemoCache] = None,
                 window_ms: float = 2.0,
                 device="cuda",
                 dispatch_workers: int = 1,
                 join_timeout_s: float = 5.0):
        self.device = env_lib.resolve_device(device)
        self.cache = cache if cache is not None else CostMemoCache()
        self._window_s = max(window_ms, 0.0) / 1e3
        self._join_timeout_s = float(join_timeout_s)
        self._pending: List[_Item] = []
        self._cv = threading.Condition()
        self._closed = False
        self._stats_lock = threading.Lock()
        self._active = 0
        self._stats = {
            "dispatches": 0, "fused_dispatches": 0, "items": 0,
            "points": 0, "unique_points": 0, "fresh_points": 0,
            "max_items_per_dispatch": 0, "max_points_per_dispatch": 0,
            "dispatch_workers": max(int(dispatch_workers), 1),
            "max_concurrent_dispatches": 0,
            "leaked_dispatch_threads": 0,
            "dispatch_seconds": 0.0,
        }
        # Each dispatcher thread's stream and pinned buffers (on a card).
        self._io = threading.local()
        self._threads = [
            threading.Thread(target=self._loop,
                             name=f"cost-eval-batcher-{i}", daemon=True)
            for i in range(max(int(dispatch_workers), 1))]
        for t in self._threads:
            t.start()

    # -- client side --------------------------------------------------------
    def evaluate(self, layers, pe, kt, df, ecfg, budget) -> np.ndarray:
        """Blocking genome-batch evaluation; safe from any thread.

        layers: (N, NUM_FIELDS); pe/kt: (b, N) raw f32 values; df: scalar or
        (b, N); ecfg: the request's EnvConfig; budget: the env's constraint
        budget.  Returns (b,) f32 fitness (+inf = infeasible), bit-identical
        to the serial engines' evaluation of the same genomes on the
        batcher's device.
        """
        return self._submit(layers, pe, kt, df, ecfg, budget, multi=False)

    def evaluate_costs(self, layers, pe, kt, df, ecfg, budget) -> np.ndarray:
        """Like :meth:`evaluate`, but returns (b, 4) aggregated whole-model
        (lat, en, area, pw) costs: the eval hook of the ``nsga2`` engine,
        bit-identical to its in-graph fitness and to
        :func:`make_local_costs_eval` on the same genomes."""
        return self._submit(layers, pe, kt, df, ecfg, budget, multi=True)

    def _submit(self, layers, pe, kt, df, ecfg, budget,
                multi: bool) -> np.ndarray:
        if self._closed:
            raise RuntimeError("CostEvalBatcher is closed")
        pe = np.asarray(pe, np.float32)
        item = _Item(pack_point_rows(layers, pe, kt, df), pe.shape, ecfg,
                     np.float32(budget), multi)
        if obs_state.enabled:
            item.recorder = obs_recorder.current_recorder()
            item.t_enqueue = time.perf_counter()
        with self._cv:
            if self._closed:
                raise RuntimeError("CostEvalBatcher is closed")
            self._pending.append(item)
            obs_instrument.BATCHER_QUEUE_DEPTH.set(len(self._pending))
            self._cv.notify()
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.fit

    def stats(self) -> Dict[str, float]:
        with self._stats_lock:
            s = dict(self._stats)
        cache = {f"cache_{k}": v for k, v in self.cache.stats().items()}
        # The cache_ prefix keeps the two families disjoint; a batcher key
        # that started with cache_ would shadow a cache stat in the merge.
        overlap = set(s) & set(cache)
        if overlap:
            raise RuntimeError(f"batcher/cache stats keys collide: {overlap}")
        s.update(cache)
        return s

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        leaked = 0
        for t in self._threads:
            t.join(timeout=self._join_timeout_s)
            # join() returns whether or not the thread died.  A live worker
            # is hung inside a dispatch and will never drain _pending, so
            # every queued waiter would block forever if we stayed silent.
            if t.is_alive():
                leaked += 1
        if leaked:
            with self._cv:
                stranded, self._pending = self._pending, []
            err = RuntimeError(
                f"CostEvalBatcher closed with {leaked} hung dispatch "
                f"thread(s); pending evaluations abandoned")
            for it in stranded:
                if not it.event.is_set():
                    it.error = err
                    it.event.set()
        with self._stats_lock:
            self._stats["leaked_dispatch_threads"] = leaked

    # -- dispatcher side ----------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
            if self._window_s:
                time.sleep(self._window_s)
            with self._cv:
                items, self._pending = self._pending, []
                obs_instrument.BATCHER_QUEUE_DEPTH.set(0)
            if not items:
                continue
            with self._stats_lock:
                self._active += 1
                self._stats["max_concurrent_dispatches"] = max(
                    self._stats["max_concurrent_dispatches"], self._active)
            try:
                self._dispatch(items)
            except Exception as e:  # noqa: BLE001 -- never stall waiters
                for it in items:
                    if not it.event.is_set():
                        it.error = e
                        it.event.set()
            finally:
                with self._stats_lock:
                    self._active -= 1

    def _device_io(self) -> Optional["_DeviceIO"]:
        """The calling thread's :class:`_DeviceIO`, made on its first
        dispatch (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        io = getattr(self._io, "io", None)
        if io is None:
            io = self._io.io = _DeviceIO(self.device)
        return io

    def _dispatch(self, items: List[_Item]) -> None:
        t0 = time.perf_counter()
        io = self._device_io()
        with obs_trace.span("batcher.dispatch") as sp:
            rows = (items[0].points if len(items) == 1
                    else np.concatenate([it.points for it in items], axis=0))
            # Dedupe on each row's bytes, the cache's key: one sort of (P,)
            # opaque 44-byte items (np.unique(rows, axis=0) sorts a
            # structured dtype field by field, several times slower).
            flat = np.ascontiguousarray(rows).view(_ROW_BYTES).reshape(-1)
            uniq, first, inv = np.unique(flat, return_index=True,
                                         return_inverse=True)
            inv = inv.reshape(-1)
            keys = uniq.tolist()                    # bytes, as u.tobytes()
            values, miss_index = self.cache.get_many(keys)
            t_eval = 0.0
            if miss_index:
                te = time.perf_counter() if obs_state.enabled else 0.0
                fresh = eval_point_rows(rows[first[miss_index]], self.device,
                                        io)
                if obs_state.enabled:
                    t_eval = time.perf_counter() - te
                # Cache per-row COPIES: a row view would pin the whole
                # dispatch's result array in memory for as long as any one
                # point stays hot.
                self.cache.put_many([keys[i] for i in miss_index],
                                    [f.copy() for f in fresh])
                for i, v in zip(miss_index, fresh):
                    values[i] = v
            per_point = np.stack(values)[inv]      # (P, 4)
            fits = aggregate_items(per_point, items, self.device, io)
            sp.set(items=len(items), points=len(rows), unique=len(uniq),
                   fresh=len(miss_index))
        dt = time.perf_counter() - t0
        # Credit the riders before releasing them, so a search's summary
        # already holds its last dispatch when its run returns.
        if obs_state.enabled:
            self._record_dispatch(items, t0, dt, t_eval, len(uniq),
                                  miss_index, first)
        for it, fit in zip(items, fits):
            it.fit = fit
            it.event.set()

        with self._stats_lock:
            s = self._stats
            s["dispatches"] += 1
            s["fused_dispatches"] += len(items) > 1
            s["items"] += len(items)
            s["points"] += len(rows)
            s["unique_points"] += len(uniq)
            s["fresh_points"] += len(miss_index)
            s["max_items_per_dispatch"] = max(
                s["max_items_per_dispatch"], len(items))
            s["max_points_per_dispatch"] = max(
                s["max_points_per_dispatch"], len(rows))
            s["dispatch_seconds"] += dt

    def _record_dispatch(self, items: List[_Item], t0: float, dt: float,
                         t_eval: float, n_uniq: int, miss_index,
                         first) -> None:
        """Telemetry for one finished dispatch: process-wide metrics plus
        per-item flight-recorder attribution (each rider is credited its
        own share of the fused batch, its own cached-vs-fresh split too).

        Fresh credit is *first-claim*: when several submitted points (of
        one item or of different riders) collapse onto one fresh unique
        row, only the first submitted occurrence (``first``, from
        ``np.unique``) is credited ``fresh`` -- the rest ride the same
        evaluation and count ``cached``.  So ``sum(per-rider fresh) ==
        dispatcher fresh_points`` exactly."""
        n_points = sum(it.points.shape[0] for it in items)
        obs_instrument.BATCHER_DISPATCHES.inc()
        obs_instrument.BATCHER_POINTS.inc(n_points, kind="submitted")
        obs_instrument.BATCHER_POINTS.inc(n_uniq, kind="unique")
        obs_instrument.BATCHER_POINTS.inc(len(miss_index), kind="fresh")
        obs_instrument.BATCHER_FUSE_WIDTH.observe(len(items))
        obs_instrument.BATCHER_DISPATCH_SECONDS.observe(dt)
        fresh_pp = None
        if any(it.recorder is not None for it in items):
            fresh_pp = np.zeros(n_points, bool)   # per submitted point
            fresh_pp[first[miss_index]] = True    # first claimant only
        off = 0
        for it in items:
            n = it.points.shape[0]
            wait = (t0 - it.t_enqueue) if it.t_enqueue else 0.0
            obs_instrument.BATCHER_QUEUE_WAIT.observe(max(wait, 0.0))
            rec = it.recorder
            if rec is not None:
                n_fresh = int(fresh_pp[off:off + n].sum())
                rec.add("eval_batches")
                rec.add("points", n)
                rec.add("fresh_points", n_fresh)
                rec.add("cached_points", n - n_fresh)
                if it.t_enqueue:
                    rec.observe("queue_wait_s", max(wait, 0.0))
                rec.observe("dispatch_s", dt)
                rec.observe("device_s", t_eval)
                rec.observe("fuse_width", len(items))
            off += n


class _DeviceIO:
    """A dispatcher thread's CUDA stream and pinned host buffers on one
    card, made once per thread (``CostEvalBatcher._device_io``).

    A dispatch runs every upload, launch, reduction and download on its
    thread's stream and waits on that stream alone: the stream does not
    wait for the legacy default stream, where the searches queue their own
    work (GA generations, a ``reinforce`` request's CUDA-graph replays).
    Tensors made on the stream are used only there.  The host buffers are
    pinned, so copies to and from the card go straight to the stream, and
    grow by powers of two, so a warm thread allocates no pinned memory
    (an allocation synchronizes the device).  A buffer is refilled only
    after the stream has drained: each use ends in a synchronize.
    """

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self._host: Dict[str, torch.Tensor] = {}

    def host(self, name: str, n: int) -> torch.Tensor:
        """The first ``n`` float32 of pinned buffer ``name``."""
        buf = self._host.get(name)
        if buf is None or buf.numel() < n:
            buf = torch.empty(1 << max(n - 1, 255).bit_length(),
                              dtype=torch.float32, pin_memory=True)
            self._host[name] = buf
        return buf[:n]


def eval_point_rows(rows: np.ndarray, device,
                    io: Optional[_DeviceIO] = None) -> np.ndarray:
    """Evaluate (M, ROW_WIDTH) fresh points on ``device`` -> (M, 4) f32.

    One call of the per-row cost kernel (its plain version on the CPU): on
    a card, one upload of the rows from the pinned buffer of ``io`` (the
    calling dispatcher thread's; a new one if None), one launch that
    reads the layer fields and pe / kt / df as columns of that upload and
    writes each point's four costs as one row, one download into pinned
    memory and one wait, all on the stream of ``io``.
    Per-point results do not depend on M or on the other rows, so any
    caller packing the same row gets the same bytes -- the property both
    the memo cache and serial == service-batched byte identity rest on.
    """
    rows = np.asarray(rows, np.float32)
    M = rows.shape[0]
    if device.type == "cpu":
        with obs_instrument.dispatch_span("cost_eval_torch", key=M):
            return _point_costs(torch.from_numpy(rows)).numpy()
    io = io or _DeviceIO(device)
    host_rows = io.host("rows", M * ROW_WIDTH).view(M, ROW_WIDTH)
    host_rows.numpy()[...] = rows
    host_out = io.host("costs", M * 4).view(M, 4)
    # The span ends after the stream's synchronize below, which the
    # function makes anyway: it times the device round trip, no extra sync.
    with obs_instrument.dispatch_span("cost_eval_kernel", key=M):
        with torch.cuda.stream(io.stream):
            host_out.copy_(
                _point_costs(host_rows.to(device, non_blocking=True)),
                non_blocking=True)
        io.stream.synchronize()
    return host_out.numpy().copy()


def _point_costs(t: torch.Tensor) -> torch.Tensor:
    """(M, ROW_WIDTH) packed rows -> (M, 4) costs, read in place."""
    return ops.batched_cost_multi(t[:, :NUM_FIELDS], t[:, _PE_COL],
                                  t[:, _KT_COL], t[:, _DF_COL],
                                  interleaved=True)


def aggregate_items(vals: np.ndarray, items, device,
                    io: Optional[_DeviceIO] = None) -> List[np.ndarray]:
    """(P, 4) per-point values of ``items``, in order -> each item's (b,)
    f32 fitness, +inf where infeasible, or for a costs item (``multi``)
    its (b, 4) f32 whole-model (lat, en, area, pw).

    Each item gets the serial engines' reduction
    (:func:`env.aggregate_costs`, or NSGA-II's
    :func:`env.stacked_costs_multi`) over its own (b, N) shape, on
    ``device``: its four (b, N) tensors are views of one freshly
    allocated (4, b, N) block, as the cost kernel returns them, filled on
    the device from the dispatch's upload (PyTorch picks vectorised loads
    by a pointer's alignment, which can change the order of a sum, so a
    view at another offset of the upload could round differently); the
    budget is a float32 0-d tensor, as in ``EnvArrays``.  On a card the
    values and budgets of all items go up in one copy and all fitnesses
    come back in one, through the pinned buffers and on the stream of
    ``io`` (a new one if None), with one wait.
    """
    sizes = [it.points.shape[0] for it in items]
    P = sum(sizes)
    n = P * 4 + len(items)
    on_card = device.type == "cuda"
    if on_card:
        io = io or _DeviceIO(device)
        host = io.host("values", n)
        ctx = torch.cuda.stream(io.stream)
    else:
        host = torch.empty(n, dtype=torch.float32)
        ctx = contextlib.nullcontext()
    flat = host.numpy()
    flat[:P * 4] = vals.reshape(-1)
    flat[P * 4:] = [it.budget for it in items]
    with ctx:
        up = host.to(device, non_blocking=True)
        per_point, budgets = up[:P * 4].view(P, 4), up[P * 4:]
        fits, off = [], 0
        for k, (it, size) in enumerate(zip(items, sizes)):
            b, N = it.shape
            block = torch.empty((4, b, N), dtype=torch.float32,
                                device=device)
            block.copy_(per_point[off:off + size].T.reshape(4, b, N))
            if it.multi:
                fits.append(env_lib.stacked_costs_multi(
                    *block.unbind(0), it.ecfg, budgets[k]).view(-1))
            else:
                perf, _, feas = env_lib.aggregate_costs(*block.unbind(0),
                                                        it.ecfg, budgets[k])
                fits.append(torch.where(feas, perf, torch.inf))
            off += size
        fit = torch.cat(fits)
        if on_card:
            fit = io.host("fitness", fit.shape[0]).copy_(fit,
                                                         non_blocking=True)
            io.stream.synchronize()
    shapes = [(it.shape[0], 4) if it.multi else (it.shape[0],)
              for it in items]
    bounds = np.cumsum([int(np.prod(sh)) for sh in shapes])[:-1]
    return [f.reshape(sh).copy()
            for sh, f in zip(shapes, np.split(fit.numpy(), bounds))]


def pack_point_rows(layers, pe, kt, df) -> np.ndarray:
    """(N, NUM_FIELDS) layers x (b, N) assignments -> (b*N, ROW_WIDTH) rows
    in the batcher/cache key format."""
    layers = np.asarray(layers, np.float32)
    pe = np.asarray(pe, np.float32)
    b, N = pe.shape
    kt = np.broadcast_to(np.asarray(kt, np.float32), (b, N))
    df = np.broadcast_to(np.asarray(df, np.float32), (b, N))
    points = np.empty((b * N, ROW_WIDTH), np.float32)
    points[:, :NUM_FIELDS] = np.broadcast_to(
        layers, (b, N, NUM_FIELDS)).reshape(-1, NUM_FIELDS)
    points[:, _PE_COL] = pe.ravel()
    points[:, _KT_COL] = kt.ravel()
    points[:, _DF_COL] = df.ravel()
    return points


def make_local_costs_eval(env: env_lib.EnvArrays,
                          ecfg: env_lib.EnvConfig):
    """Serial NSGA-II's default fitness hook: ``eval_fn(pe, kt, df) ->
    (b, 4)`` aggregated costs through the programs a
    :class:`CostEvalBatcher` dispatch runs -- :func:`eval_point_rows` (one
    per-row kernel launch on the card) and :func:`aggregate_items` on the
    env's device -- without the queue, fusion window and memo cache.
    Per-point results do not depend on the batch, so a serial
    ``run_search`` and a service-batched one give the same bytes by
    construction.
    """
    layers = env.layers.cpu().numpy()
    budget = np.float32(env.budget.cpu().numpy())
    device = env.device
    io = _DeviceIO(device) if device.type == "cuda" else None

    def eval_fn(pe, kt, df):
        pe = np.asarray(pe, np.float32)
        item = _Item(pack_point_rows(layers, pe, kt, df), pe.shape, ecfg,
                     budget, multi=True)
        vals = eval_point_rows(item.points, device, io)
        return aggregate_items(vals, [item], device, io)[0]

    return eval_fn
