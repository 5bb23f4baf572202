"""The port's telemetry layer (``repro_torch.obs``) against the reference's
(``repro.obs``) on the same inputs, plus ports of tests/test_obs.py's unit
tests: the metrics registry, the tracer, the flight recorder, the compile
tracker, and the cache and batcher accounting (a multi-thread batcher
hammer with exact counters and per-rider attribution) on the CPU.

Parity means: the same counter / gauge / histogram updates give the same
Prometheus bytes and JSON snapshot, the same span nesting gives the same
depth / parent / attribute structure (timestamps aside), the same recorder
calls give the same summary, and the two catalogs hold the same metric and
span names, help strings, labels and bucket edges.
"""
import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.obs import metrics as ref_metrics
from repro.obs import recorder as ref_recorder
from repro.obs import trace as ref_trace
from repro_torch import api, obs
from repro_torch.core import env as env_lib
from repro_torch.costmodel import workloads
from repro_torch.obs import instrument, metrics, recorder
from repro_torch.obs import trace as trace_mod
from repro_torch.serving.batcher import (CostEvalBatcher, eval_point_rows,
                                        pack_point_rows)
from repro_torch.serving.cost_cache import CostMemoCache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ECFG = env_lib.EnvConfig(platform="cloud")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_obs():
    """Telemetry is process-global in both packages: every test starts and
    ends disabled with zeroed metrics, whatever it does in between."""
    for o in (obs, ref_obs):
        o.disable()
        o.reset()
    yield
    for o in (obs, ref_obs):
        o.disable()
        o.reset()


def _enabled():
    obs.enable(trace=True)


def _checker():
    spec = importlib.util.spec_from_file_location(
        "check_telemetry", os.path.join(REPO, "tools", "check_telemetry.py"))
    checker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(checker)
    return checker


# ---------------------------------------------------------------------------
# Parity with the reference on the same inputs.
# ---------------------------------------------------------------------------
def _drive_registry(reg):
    """One fixed sequence of updates, escaping and odd values included."""
    c = reg.counter("p_requests", 'help with "quotes" and \\ slash',
                    labels=("route", "code"))
    g = reg.gauge("p_depth", "queue depth")
    h = reg.histogram("p_seconds", "latency", labels=("engine",))
    hs = reg.histogram("p_width", "fuse width",
                       buckets=metrics.DEFAULT_SIZE_BUCKETS)
    u = reg.counter("p_plain", "unlabelled")
    c.inc(route="/v1/search/{uid}", code="200")
    c.inc(2.5, route="/v1/stats", code="200")
    c.inc(route='a"b\nc', code="500")
    g.set(7)
    g.inc(2.25)
    g.dec()
    for v in (0.0, 3e-6, 1e-5, 0.02, 0.7, 12.0, 45.0, 1e-4):
        h.observe(v, engine="ga")
    h.observe(0.3, engine="nsga2")
    for w in (1, 3, 8, 9, 5000):
        hs.observe(w)
    u.inc(3)
    return c, g, h


@pytest.mark.parametrize("fmt", ["prometheus", "snapshot"])
def test_registry_exports_equal_the_reference(fmt, tmp_path):
    """The same updates on a fresh MetricsRegistry of each package give
    byte-equal Prometheus text, equal snapshots and equal files."""
    obs.enable(trace=False)
    ref_obs.enable(trace=False)
    mine, ref = metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    _drive_registry(mine)
    _drive_registry(ref)
    if fmt == "prometheus":
        assert mine.prometheus_text() == ref.prometheus_text()
        ext = ".prom"
    else:
        assert mine.snapshot() == ref.snapshot()
        ext = ".json"
    a, b = tmp_path / f"a{ext}", tmp_path / f"b{ext}"
    metrics.write_prometheus(str(a), mine)
    ref_metrics.write_prometheus(str(b), ref)
    assert a.read_bytes() == b.read_bytes()


def test_histogram_stats_and_gating_equal_the_reference():
    mine, ref = metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    _drive_registry(mine)                 # both disabled: nothing recorded
    _drive_registry(ref)
    assert mine.prometheus_text() == ref.prometheus_text()
    assert "p_plain_total" not in mine.prometheus_text()
    obs.enable(trace=False)
    ref_obs.enable(trace=False)
    _, _, h = _drive_registry(mine)
    _, _, rh = _drive_registry(ref)
    assert h.stats(engine="ga") == rh.stats(engine="ga")
    assert h.stats(engine="none") == rh.stats(engine="none")


def _nest(tracer):
    with tracer.span("search.run", method="ga", eps=100, seed=np.int64(3)):
        with tracer.span("search.chunk", engine="ga", start=0, steps=5):
            with tracer.span("xla.dispatch", program="p", compile=True):
                pass
        with tracer.span("search.chunk", engine="ga", start=5) as sp:
            sp.set(extra=np.float32(0.5), obj=object.__name__)
    with tracer.span("batcher.dispatch"):
        pass


_TIMING = ("ts_us", "dur_us", "tid", "ts", "dur", "pid")


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in _TIMING}


def test_span_structure_equals_the_reference(tmp_path):
    """The same span nesting gives the same names, depths, parents and
    attributes in the ring, the JSONL sink and the Chrome export."""
    mine = trace_mod.Tracer(jsonl_path=str(tmp_path / "a.jsonl"))
    ref = ref_trace.Tracer(jsonl_path=str(tmp_path / "b.jsonl"))
    _nest(mine)
    _nest(ref)
    mine.close()
    ref.close()
    assert [_strip(r) for r in mine.spans()] == \
        [_strip(r) for r in ref.spans()]
    a = [json.loads(ln) for ln in (tmp_path / "a.jsonl").read_text()
         .splitlines()]
    b = [json.loads(ln) for ln in (tmp_path / "b.jsonl").read_text()
         .splitlines()]
    assert [_strip(r) for r in a] == [_strip(r) for r in b]
    assert [sorted(r) for r in a] == [sorted(r) for r in b]
    ca, cb = mine.chrome_trace(), ref.chrome_trace()
    assert ca["displayTimeUnit"] == cb["displayTimeUnit"]
    assert [_strip(e) for e in ca["traceEvents"]] == \
        [_strip(e) for e in cb["traceEvents"]]
    for path, t in (("a.json", mine), ("b.jsonl", ref)):
        t.save(str(tmp_path / "out" / path))
    assert json.loads((tmp_path / "out" / "a.json").read_text())[
        "traceEvents"]


def _drive_recorder(rec):
    rec.add("points", 10)
    rec.add("cached_points", 4)
    rec.add("fresh_points", 6)
    rec.add("hard_evals", 2.5)
    rec.add("chunks")
    for v in (0.2, 0.4, 1e-7):
        rec.observe("dispatch_s", v)
    rec.observe("queue_wait_s", 3)


def test_recorder_summary_equals_the_reference():
    mine = recorder.FlightRecorder(engine="ga")
    ref = ref_recorder.FlightRecorder(engine="ga")
    assert mine.summary() == ref.summary()
    _drive_recorder(mine)
    _drive_recorder(ref)
    assert mine.summary() == ref.summary()
    assert json.dumps(mine.summary()) == json.dumps(ref.summary())


# The spans the port records beyond the reference's
# (docs/observability_torch.md).
PORT_SPAN_NAMES = ("search.prepare", "graph.capture")


def test_catalog_names_equal_the_reference():
    from repro.obs import instrument as ref_instrument

    assert instrument.METRIC_NAMES == ref_instrument.METRIC_NAMES
    # The reference's span names first, then exactly the port's own.
    n = len(ref_instrument.SPAN_NAMES)
    assert instrument.SPAN_NAMES[:n] == ref_instrument.SPAN_NAMES
    assert instrument.SPAN_NAMES[n:] == PORT_SPAN_NAMES
    mine = {m.name: m for m in metrics.REGISTRY.metrics()}
    ref = {m.name: m for m in ref_metrics.REGISTRY.metrics()}
    for name in instrument.METRIC_NAMES:
        a, b = mine[name], ref[name]
        assert (a.kind, a.help, a.label_names) == \
            (b.kind, b.help, b.label_names), name
        assert getattr(a, "buckets", None) == getattr(b, "buckets", None)


def test_exposition_passes_the_telemetry_checker(tmp_path):
    """The registry's own output satisfies tools/check_telemetry.py."""
    _enabled()
    instrument.SEARCH_HARD_EVALS.inc(100, engine="ga")
    instrument.SEARCH_CHUNK_SECONDS.observe(0.5, engine="ga")
    instrument.BATCHER_QUEUE_DEPTH.set(3)
    instrument.HTTP_REQUESTS.inc(route="/v1/search/{uid}", code="200")
    path = tmp_path / "m.prom"
    obs.write_prometheus(str(path))
    checker = _checker()
    n = checker.check_metrics(str(path), ["repro_search_hard_evals",
                                          "repro_http_requests"])
    assert n > 0
    trace = tmp_path / "t.jsonl"
    with obs.span("search.run", method="ga"):
        with instrument.dispatch_span("cost_eval_torch", key=3):
            pass
    obs.save_trace(str(trace))
    assert checker.check_trace(str(trace), ["search.run", "xla.dispatch"]) \
        == 2


# ---------------------------------------------------------------------------
# Metrics registry (ports of tests/test_obs.py).
# ---------------------------------------------------------------------------
def test_counter_counts_and_is_gated():
    c = metrics.counter("tt_obs_counter", "x", labels=("k",))
    c.inc(k="a")                      # disabled -> dropped
    assert c.value(k="a") == 0.0
    _enabled()
    c.inc(k="a")
    c.inc(2.5, k="a")
    c.inc(k="b")
    assert c.value(k="a") == 3.5 and c.value(k="b") == 1.0
    with pytest.raises(ValueError):
        c.inc(-1.0, k="a")            # counters only go up
    with pytest.raises(ValueError):
        c.inc(wrong="label")


def test_gauge_up_down():
    g = metrics.gauge("tt_obs_gauge", "x")
    _enabled()
    g.set(5.0)
    g.inc()
    g.dec(2.0)
    assert g.value() == 4.0


def test_histogram_stats_and_buckets():
    h = metrics.histogram("tt_obs_hist", "x", buckets=(1.0, 10.0))
    _enabled()
    for v in (0.5, 5.0, 50.0):
        h.observe(v)
    st = h.stats()
    assert st["count"] == 3 and st["max"] == 50.0
    assert st["sum"] == pytest.approx(55.5)
    text = obs.REGISTRY.prometheus_text()
    assert 'tt_obs_hist_bucket{le="1.0"} 1' in text
    assert 'tt_obs_hist_bucket{le="10.0"} 2' in text
    assert 'tt_obs_hist_bucket{le="+Inf"} 3' in text
    assert "tt_obs_hist_count 3" in text


def test_registry_get_or_create_and_conflicts():
    a = metrics.counter("tt_obs_same", "x", labels=("k",))
    b = metrics.counter("tt_obs_same", "x", labels=("k",))
    assert a is b
    with pytest.raises(ValueError):
        metrics.gauge("tt_obs_same")                   # kind conflict
    with pytest.raises(ValueError):
        metrics.counter("tt_obs_same", labels=("other",))   # label conflict


def test_counters_expose_total_suffix_and_reset_zeroes():
    c = metrics.counter("tt_obs_totaled", "x")
    _enabled()
    c.inc(3)
    text = obs.REGISTRY.prometheus_text()
    assert "tt_obs_totaled_total 3.0" in text
    assert "\ntt_obs_totaled 3.0" not in text
    snap = obs.REGISTRY.snapshot()["tt_obs_totaled"]
    assert snap["kind"] == "counter" and snap["values"][""] == 3.0
    obs.REGISTRY.reset()
    assert c.value() == 0.0


# ---------------------------------------------------------------------------
# Tracer.
# ---------------------------------------------------------------------------
def test_spans_nest_with_depth_and_parent():
    t = trace_mod.Tracer()
    with t.span("outer", k=1):
        with t.span("inner"):
            pass
    inner, outer = t.spans()
    assert inner["name"] == "inner" and inner["depth"] == 1
    assert inner["parent"] == "outer"
    assert outer["name"] == "outer" and outer["depth"] == 0
    assert "parent" not in outer
    assert outer["attrs"] == {"k": 1}
    assert outer["dur_us"] >= inner["dur_us"] >= 0


def test_ring_bounds_and_counts_drops():
    t = trace_mod.Tracer(ring=2)
    for i in range(5):
        with t.span(f"s{i}"):
            pass
    assert [r["name"] for r in t.spans()] == ["s3", "s4"]
    assert t.dropped == 3
    t.clear()
    assert t.spans() == [] and t.dropped == 0


def test_disabled_span_is_the_shared_null():
    assert trace_mod.span("x") is trace_mod.NULL_SPAN
    with trace_mod.span("x", a=1) as sp:
        assert sp.set(b=2) is sp      # chaining-safe on the disabled path
    _enabled()
    with trace_mod.span("real") as sp:
        assert sp is not trace_mod.NULL_SPAN
    obs.disable()
    assert trace_mod.span("x") is trace_mod.NULL_SPAN


def test_enable_keeps_or_replaces_the_tracer(tmp_path):
    obs.enable(trace=True)
    t = obs.tracer()
    obs.enable(trace=True)
    assert obs.tracer() is t          # idempotent
    obs.enable(trace=True, jsonl_path=str(tmp_path / "s.jsonl"))
    assert obs.tracer() is not t      # a new sink gets a new tracer
    with obs.span("service.search"):
        pass
    obs.disable()
    assert not obs.enabled()
    assert [r["name"] for r in obs.tracer().spans()] == ["service.search"]
    assert json.loads((tmp_path / "s.jsonl").read_text())["name"] == \
        "service.search"
    from repro_torch.obs import state

    state.tracer.close()
    state.tracer = t                  # no sink left open for other tests


def test_save_trace_needs_a_tracer(tmp_path):
    from repro_torch.obs import state

    saved, state.tracer = state.tracer, None
    try:
        with pytest.raises(RuntimeError):
            obs.save_trace(str(tmp_path / "t.json"))
    finally:
        state.tracer = saved


def test_jsonl_sink_and_chrome_export(tmp_path):
    jsonl = tmp_path / "t.jsonl"
    t = trace_mod.Tracer(jsonl_path=str(jsonl))
    with t.span("a", n=3):
        pass
    t.close()
    recs = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    assert len(recs) == 1 and recs[0]["name"] == "a"
    assert recs[0]["attrs"] == {"n": 3}
    ct = t.chrome_trace()
    (ev,) = ct["traceEvents"]
    assert ev["ph"] == "X" and ev["name"] == "a" and ev["dur"] >= 0
    out = tmp_path / "t.json"
    t.save(str(out))
    assert json.loads(out.read_text())["traceEvents"]


# ---------------------------------------------------------------------------
# Flight recorder.
# ---------------------------------------------------------------------------
def test_recorder_summary_counts_series_and_ratios():
    r = recorder.FlightRecorder(engine="ga")
    r.add("points", 10)
    r.add("cached_points", 4)
    r.add("fresh_points", 6)
    r.observe("dispatch_s", 0.2)
    r.observe("dispatch_s", 0.4)
    s = r.summary()
    assert s["engine"] == "ga" and s["points"] == 10
    assert s["cache_hit_rate"] == pytest.approx(0.4)
    assert s["fresh_frac"] == pytest.approx(0.6)
    d = s["dispatch_s"]
    assert d["count"] == 2 and d["max"] == pytest.approx(0.4)
    assert d["mean"] == pytest.approx(0.3)


def test_recording_is_thread_local_and_gated():
    r = recorder.FlightRecorder()
    recorder.record("k")              # no recorder, disabled -> no-op
    _enabled()
    with recorder.recording(r):
        recorder.record("k", 2)
        recorder.observe("s", 1.5)
        seen = []
        th = threading.Thread(
            target=lambda: seen.append(recorder.current_recorder()))
        th.start()
        th.join()
        assert seen == [None]         # other threads see no recorder
    recorder.record("k")              # uninstalled again
    assert r.count("k") == 2.0
    assert r.summary()["s"]["count"] == 1


# ---------------------------------------------------------------------------
# Dispatch / compile tracking.
# ---------------------------------------------------------------------------
def test_dispatch_span_counts_first_sighting_as_compile():
    _enabled()
    rec = recorder.FlightRecorder()
    with recorder.recording(rec):
        for _ in range(3):
            with instrument.dispatch_span("t_prog", key=256):
                pass
        with instrument.dispatch_span("t_prog", key=512):
            pass
    assert instrument.JIT_COMPILES.value(program="t_prog") == 2.0
    assert instrument.DISPATCH_SECONDS.stats(program="t_prog")["count"] == 4
    assert rec.count("jit_compiles") == 2.0
    spans = [s for s in obs.tracer().spans() if s["name"] == "xla.dispatch"]
    assert [s["attrs"]["compile"] for s in spans] == [
        True, False, False, True]
    assert rec.summary()["t_prog_dispatch_s"]["count"] == 4


def test_dispatch_span_is_free_when_disabled():
    with instrument.dispatch_span("t_off", key=1):
        pass
    _enabled()
    assert instrument.DISPATCH_SECONDS.stats(program="t_off")["count"] == 0
    # The disabled sighting did not claim the compile.
    assert instrument.first_dispatch("t_off", 1)


def test_hard_evals_helper_feeds_registry_and_recorder():
    instrument.hard_evals("random", 50)      # disabled -> free no-op
    assert instrument.SEARCH_HARD_EVALS.value(engine="random") == 0.0
    _enabled()
    rec = recorder.FlightRecorder()
    with recorder.recording(rec):
        instrument.hard_evals("random", 50)
    assert instrument.SEARCH_HARD_EVALS.value(engine="random") == 50.0
    assert rec.count("hard_evals") == 50.0


def test_chunk_metrics_feed_registry_and_recorder():
    _enabled()
    rec = recorder.FlightRecorder()
    with recorder.recording(rec):
        instrument.chunk_metrics("sa", steps=10, evals=10, seconds=0.25)
        instrument.chunk_metrics("sa", steps=5, evals=5, seconds=0.5)
    assert instrument.SEARCH_CHUNKS.value(engine="sa") == 2.0
    assert instrument.SEARCH_HARD_EVALS.value(engine="sa") == 15.0
    s = rec.summary()
    assert s["chunks"] == 2 and s["hard_evals"] == 15
    assert s["chunk_s"]["count"] == 2


def test_eval_point_rows_on_the_cpu_is_one_plain_dispatch():
    """On the CPU the per-row evaluation runs the plain version inside one
    ``cost_eval_torch`` dispatch span keyed by the row count."""
    env = env_lib.make_env(workloads.get_workload("ncf"), ECFG, "cpu")
    layers = env.layers.numpy()
    N = layers.shape[0]
    rows = pack_point_rows(layers, np.full((2, N), 16, np.float32),
                           np.full((2, N), 4, np.float32), 0.0)
    plain = eval_point_rows(rows, CPU)
    _enabled()
    rec = recorder.FlightRecorder()
    with recorder.recording(rec):
        got = eval_point_rows(rows, CPU)
        eval_point_rows(rows, CPU)
    assert got.tobytes() == plain.tobytes()
    assert instrument.JIT_COMPILES.value(program="cost_eval_torch") == 1.0
    assert instrument.DISPATCH_SECONDS.stats(
        program="cost_eval_torch")["count"] == 2
    assert instrument.DISPATCH_SECONDS.stats(
        program="cost_eval_kernel")["count"] == 0
    assert rec.summary()["cost_eval_torch_dispatch_s"]["count"] == 2
    (sp, _) = [s for s in obs.tracer().spans()
               if s["name"] == "xla.dispatch"]
    assert sp["attrs"] == {"program": "cost_eval_torch", "compile": True}


# ---------------------------------------------------------------------------
# Cache + batcher accounting.
# ---------------------------------------------------------------------------
def test_empty_cache_hit_rate_is_zero():
    cache = CostMemoCache()
    assert cache.hit_rate == 0.0
    assert cache.stats()["hit_rate"] == 0.0


def test_cache_lookups_and_evictions_match_its_own_counts():
    cache = CostMemoCache(capacity=3)
    vals = [np.full(4, i, np.float32) for i in range(5)]
    keys = [bytes([i]) * 8 for i in range(5)]
    cache.get_many(keys[:2])          # disabled: not counted in metrics
    _enabled()
    cache.get_many(keys[:3])
    cache.put_many(keys, vals)        # 5 into capacity 3: 2 evictions
    got, miss = cache.get_many(keys)
    assert miss == [0, 1]
    assert got[4].tobytes() == vals[4].tobytes()
    lk = instrument.CACHE_LOOKUPS
    assert lk.value(result="miss") == 3 + 2
    assert lk.value(result="hit") == 3
    assert instrument.CACHE_EVICTIONS.value() == cache.evictions == 2
    assert instrument.CACHE_LOOKUP_SECONDS.stats()["count"] == 2


def test_batcher_cache_stats_merge_rejects_colliding_keys():
    b = CostEvalBatcher(device="cpu")
    try:
        s = b.stats()
        assert s["cache_hits"] == 0           # cache_ namespaced in
        assert "dispatches" in s
        with b._stats_lock:
            b._stats["cache_hits"] = 99
        with pytest.raises(RuntimeError, match="collide"):
            b.stats()
    finally:
        with b._stats_lock:
            b._stats.pop("cache_hits", None)
        b.close()


def test_batcher_hammer_exact_counters_and_attribution():
    """N searches hammer one batcher from worker threads; every
    process-wide counter and per-search flight-recorder count comes out
    exact (no lost updates), and concurrency stays within the pool."""
    _enabled()
    env = env_lib.make_env(workloads.get_workload("ncf"), ECFG, "cpu")
    layers = env.layers.numpy()
    budget = np.float32(env.budget.numpy())
    N = layers.shape[0]
    T, K, B = 4, 3, 8            # threads x submits x genomes-per-submit
    workers = 2
    b = CostEvalBatcher(window_ms=1.0, device="cpu",
                        dispatch_workers=workers)
    recs = [recorder.FlightRecorder(engine=f"t{i}") for i in range(T)]
    fits = [None] * T
    errors = []

    def worker(i):
        rng = np.random.default_rng(i)
        try:
            with recorder.recording(recs[i]):
                out = []
                for _ in range(K):
                    pe = rng.integers(1, 64, (B, N)).astype(np.float32)
                    kt = rng.integers(1, 64, (B, N)).astype(np.float32)
                    out.append(b.evaluate(layers, pe, kt, 0.0, ECFG, budget))
                fits[i] = out
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(T)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    try:
        assert not errors
        assert not any(t.is_alive() for t in threads)
        s = b.stats()
        assert s["items"] == T * K
        assert s["points"] == T * K * B * N
        assert 1 <= s["dispatches"] <= T * K
        assert s["cache_hits"] + s["cache_misses"] == s["unique_points"]
        assert s["fresh_points"] == s["cache_misses"]
        assert s["max_concurrent_dispatches"] <= workers
        assert s["dispatch_workers"] == workers

        pts = instrument.BATCHER_POINTS
        assert pts.value(kind="submitted") == s["points"]
        assert pts.value(kind="unique") == s["unique_points"]
        assert pts.value(kind="fresh") == s["fresh_points"]
        assert instrument.BATCHER_DISPATCHES.value() == s["dispatches"]
        assert instrument.BATCHER_FUSE_WIDTH.stats()["count"] == \
            s["dispatches"]
        assert instrument.BATCHER_QUEUE_WAIT.stats()["count"] == T * K
        assert instrument.BATCHER_QUEUE_DEPTH.value() == 0.0
        spans = [sp for sp in obs.tracer().spans()
                 if sp["name"] == "batcher.dispatch"]
        assert len(spans) == s["dispatches"]
        assert sum(sp["attrs"]["points"] for sp in spans) == s["points"]
        assert sum(sp["attrs"]["fresh"] for sp in spans) == \
            s["fresh_points"]
        # Every fresh evaluation ran in one plain dispatch span.
        assert instrument.DISPATCH_SECONDS.stats(
            program="cost_eval_torch")["count"] == sum(
                1 for sp in spans if sp["attrs"]["fresh"])

        for r in recs:
            t = r.summary()
            assert t["eval_batches"] == K
            assert t["points"] == K * B * N
            assert t["fresh_points"] + t["cached_points"] == t["points"]
            assert t["queue_wait_s"]["count"] == K
            assert t["dispatch_s"]["count"] == K
        assert sum(r.count("fresh_points") for r in recs) == \
            s["fresh_points"]

        for out in fits:
            assert len(out) == K and all(f.shape == (B,) for f in out)
    finally:
        b.close()


def test_batcher_credits_duplicates_to_the_first_claimant():
    """Two riders submitting the same genomes in one dispatch: the fresh
    points are credited once, to whichever submitted them first."""
    _enabled()
    env = env_lib.make_env(workloads.get_workload("ncf"), ECFG, "cpu")
    layers = env.layers.numpy()
    budget = np.float32(env.budget.numpy())
    N = layers.shape[0]
    pe = np.full((3, N), 32, np.float32)     # 3 identical genomes
    kt = np.full((3, N), 5, np.float32)
    b = CostEvalBatcher(window_ms=50.0, device="cpu")
    recs = [recorder.FlightRecorder() for _ in range(2)]
    barrier = threading.Barrier(2)

    def worker(i):
        with recorder.recording(recs[i]):
            barrier.wait()
            b.evaluate(layers, pe, kt, 0.0, ECFG, budget)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    try:
        s = b.stats()
        assert s["fresh_points"] == N
        fresh = [r.count("fresh_points") for r in recs]
        assert sum(fresh) == N
        assert sorted(fresh) == [0.0, float(N)]
        for r in recs:
            assert r.count("points") == 3 * N
    finally:
        b.close()


# ---------------------------------------------------------------------------
# Outcome summary + docs catalog sync.
# ---------------------------------------------------------------------------
def test_outcome_summary_renders_telemetry():
    req = api.SearchRequest(workload="ncf", env=ECFG, eps=20, seed=3,
                            method="random", device="cpu")
    plain = api.run_search(req)
    text = plain.summary()
    assert "method=random" in text and "seed=3" in text
    assert f"best_value={plain.best_value:.6g}" in text
    assert "telemetry" not in text and plain.telemetry is None
    _enabled()
    traced = api.run_search(req)
    text = traced.summary()
    assert "telemetry: " in text and "hard_evals=20" in text
    spans = obs.tracer().spans()
    assert [s["name"] for s in spans] == ["search.prepare", "search.run"]
    assert spans[0]["attrs"] == {"part": "env"}
    assert spans[1]["attrs"] == {
        "method": "random", "eps": 20, "seed": 3}


def test_docs_document_every_metric_and_span():
    """The reference's names in docs/observability.md, the port's own
    spans in docs/observability_torch.md."""
    doc = open(os.path.join(REPO, "docs", "observability.md")).read()
    own = open(os.path.join(REPO, "docs", "observability_torch.md")).read()
    for name in instrument.METRIC_NAMES:
        assert f"`{name}`" in doc, f"{name} missing from docs/observability.md"
    for name in instrument.SPAN_NAMES:
        where = own if name in PORT_SPAN_NAMES else doc
        assert f"`{name}`" in where, f"{name} missing from its doc"
