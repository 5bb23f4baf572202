"""The port's search service on the CPU: serial parity, cache accounting,
persistence, cancellation, lifecycle, the batcher, and the CLI.

The load-bearing guarantee is exactness: a search routed through the
service -- cross-request fusion, per-point dedup and memo-cache hits
included -- returns the same bytes as the same ``api.run_search`` call run
serially on the same device.  (On the card, tests/test_torch_cuda.py and
chip_smoke.py check the same.)
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import baselines
from repro_torch.core import env as env_lib
from repro_torch.costmodel import workloads
from repro_torch.costmodel.layers import NUM_FIELDS, LayerSpec, layers_to_array
from repro_torch.serving import (CostEvalBatcher, CostMemoCache,
                                 PersistentCostCache, SearchCancelled,
                                 SearchService, ServiceConfig)
from repro_torch.serving.batcher import (ROW_WIDTH, eval_point_rows,
                                        pack_point_rows)
from torch_threads import ONE_THREAD, one_torch_thread  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ECFG = env_lib.EnvConfig(platform="cloud")
# Methods and options of the serial-parity tests: eps of a few hundred on
# ncf (reinforce: a few dozen epochs).
PARITY = [("random", {}), ("grid", {}), ("bo", {}), ("ga", {"population": 20}),
          ("sa", {}), ("reinforce", {})]


def _req(method, eps=200, seed=0, wl="ncf", **kw):
    kw.setdefault("device", "cpu")
    return api.SearchRequest(workload=wl, env=ECFG, eps=eps, seed=seed,
                             method=method, **kw)


def _svc(**kw):
    kw.setdefault("device", "cpu")
    return SearchService(ServiceConfig(**kw))


@pytest.fixture
def svc():
    s = _svc(max_workers=4, default_progress_every=50)
    yield s
    s.close()


def _assert_same(got, want):
    assert got.best_value == want.best_value
    assert got.history.tobytes() == want.history.tobytes()
    assert got.pe.tobytes() == want.pe.tobytes()
    assert got.kt.tobytes() == want.kt.tobytes()
    assert got.df.tobytes() == want.df.tobytes()


def _parity_reqs(seed):
    return [_req(m, eps=40 if m == "reinforce" else 300, seed=seed,
                 options=dict(o)) for m, o in PARITY]


# ---------------------------------------------------------------------------
# Exact parity with serial runs.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dispatch_workers", [1, 2])
def test_service_byte_identical_to_serial(dispatch_workers):
    """random, grid, bo, ga, sa and reinforce submitted together equal
    their serial runs byte for byte, with one or two dispatch threads."""
    serial = [api.run_search(r) for r in _parity_reqs(3)]
    s = _svc(max_workers=6, dispatch_workers=dispatch_workers)
    try:
        outs = s.run_all(_parity_reqs(3))
        st = s.stats()
    finally:
        s.close()
    for got, want in zip(outs, serial):
        assert got.method == want.method
        _assert_same(got, want)
    assert st["completed"] == len(PARITY) and st["failed"] == 0
    assert st["points"] > 0 and st["dispatch_workers"] == dispatch_workers


@pytest.mark.parametrize("mix", [False, True])
def test_relaxed_through_the_service_equals_serial(mix):
    """The relaxed engine's hard probes go through the batcher (one (1, N)
    item a probe): the outcome equals the serial run's byte for byte, and
    every probe reached the batcher."""
    ecfg = env_lib.EnvConfig(platform="iot", mix=mix)
    opts = {"steps_per_eval": 3, "restarts": 2}
    req = lambda: api.SearchRequest(workload="ncf", env=ecfg, eps=24,
                                    seed=2, method="relaxed",
                                    options=dict(opts), device="cpu")
    serial = api.run_search(req())
    s = _svc(max_workers=2)
    try:
        got = s.submit(req()).result(timeout=300)
        st = s.stats()
    finally:
        s.close()
    _assert_same(got, serial)
    assert got.extras == serial.extras
    N = len(workloads.get_workload("ncf"))
    assert st["points"] == 24 * N and st["items"] == 24


def _nsga2_req(**kw):
    return _req("nsga2", eps=180, seed=4,
                options={"population": 12, "archive": 16}, **kw)


def _assert_same_frontier(got, want):
    _assert_same(got, want)
    assert set(got.frontier) == set(want.frontier)
    for k in want.frontier:
        assert got.frontier[k].tobytes() == want.frontier[k].tobytes(), k
    gt, wt = got.extras["frontier_trace"], want.extras["frontier_trace"]
    assert len(gt) == len(wt) > 0
    assert all(a.tobytes() == b.tobytes() for a, b in zip(gt, wt))
    assert ({k: v for k, v in got.extras.items() if k != "frontier_trace"}
            == {k: v for k, v in want.extras.items()
                if k != "frontier_trace"})


@pytest.mark.parametrize("costs_batched", [True, False])
def test_nsga2_through_the_service_equals_serial(costs_batched):
    """NSGA-II beside a ga request on the same workload: through the
    batcher's costs path (or, with ``costs_batched_methods=()``, on its own
    evaluation), the outcome equals the serial run byte for byte,
    frontier and frontier trace included; the ga request too."""
    cb = _nsga2_req(on_progress=lambda t: None, progress_every=36)
    serial = [api.run_search(r) for r in (_nsga2_req(), cb, _req(
        "ga", eps=200, seed=4, options={"population": 10}))]
    assert len(serial[1].extras["frontier_trace"]) == 5
    s = _svc(max_workers=3, **({} if costs_batched
                               else {"costs_batched_methods": ()}))
    try:
        tickets = [s.submit(r) for r in (
            _nsga2_req(), _nsga2_req(on_progress=lambda t: None,
                                     progress_every=36),
            _req("ga", eps=200, seed=4, options={"population": 10}))]
        outs = [t.result(timeout=300) for t in tickets]
        st = s.stats()
    finally:
        s.close()
    for got, want in zip(outs[:2], serial[:2]):
        _assert_same_frontier(got, want)
    _assert_same(outs[2], serial[2])
    N = len(workloads.get_workload("ncf"))
    nsga2_items = 2 * 15 if costs_batched else 0
    assert st["items"] == nsga2_items + 20
    assert st["points"] == (nsga2_items * 12 + 20 * 10) * N


def test_costs_and_scalar_items_share_the_cache_bitwise():
    """``evaluate_costs`` gives NSGA-II's in-graph fitness byte for byte,
    a scalar item over the same genomes evaluates nothing fresh, and one
    dispatch of both kinds gives each its serial values."""
    from repro_torch.core import nsga2
    from repro_torch.serving.batcher import _Item

    env = _ncf_env()
    ecfg = env_lib.EnvConfig(platform="cloud", objective="energy")
    rng = np.random.default_rng(7)
    g = torch.from_numpy(rng.integers(0, ecfg.levels,
                                      (9, env.num_layers, 2)))
    want_costs = nsga2._multi_costs(env, ecfg, env.pe_table[g[..., 0]],
                                    env.kt_table[g[..., 1]],
                                    float(ecfg.dataflow))
    want_fit, pe, kt = baselines._decode_and_eval(env, ecfg, g)
    args = (env.layers.numpy(), pe.numpy(), kt.numpy(),
            np.float32(ecfg.dataflow), ecfg, env.budget.numpy())
    b = CostEvalBatcher(window_ms=0.0, device="cpu")
    try:
        got = b.evaluate_costs(*args)
        assert got.shape == (9, 4) and got.dtype == np.float32
        assert got.tobytes() == want_costs.numpy().tobytes()
        fresh = b.stats()["fresh_points"]
        assert b.evaluate(*args).tobytes() == want_fit.numpy().tobytes()
        assert b.stats()["fresh_points"] == fresh
        rows = pack_point_rows(*args[:4])
        items = [_Item(rows, (9, env.num_layers), ecfg, args[5], multi=m)
                 for m in (True, False, True)]
        b._dispatch(items)
    finally:
        b.close()
    assert items[0].fit.tobytes() == items[2].fit.tobytes() == got.tobytes()
    assert items[1].fit.tobytes() == want_fit.numpy().tobytes()


def test_same_query_from_two_users_agrees_and_hits_cache(svc):
    tickets = [svc.submit(_req("ga", eps=400, seed=5,
                               options={"population": 20}))
               for _ in range(2)]
    a, b = (t.result(timeout=300) for t in tickets)
    _assert_same(a, b)
    assert svc.stats()["cache_hit_rate"] > 0


def test_concurrent_stress_every_outcome_equals_serial():
    """More searches than cores and a short switch interval: every outcome
    still equals its serial run, and the batcher's books balance."""
    reqs = lambda: [_req(m, eps=150, seed=s % 3, options=dict(o))
                    for s in range(4)
                    for m, o in (("random", {}), ("ga", {"population": 10}),
                                 ("sa", {}), ("grid", {}))]
    serial = [api.run_search(r) for r in reqs()]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        s = _svc(max_workers=16, dispatch_workers=3, window_ms=0.5)
        try:
            tickets = [s.submit(r) for r in reqs()]
            outs = [t.result(timeout=300) for t in tickets]
            st = s.stats()
        finally:
            s.close()
    finally:
        sys.setswitchinterval(old)
    for got, want in zip(outs, serial):
        _assert_same(got, want)
    assert st["cache_hits"] + st["cache_misses"] == st["unique_points"]
    assert st["cache_misses"] == st["fresh_points"]
    # Two dispatchers may both miss one point and store the same bytes.
    assert 0 < st["cache_entries"] <= st["cache_misses"]
    assert st["completed"] == len(serial)


def test_run_all_preserves_request_order(svc):
    outs = svc.run_all([_req("random", eps=150, seed=s) for s in range(3)])
    assert [o.seed for o in outs] == [0, 1, 2]
    assert all(o.method == "random" for o in outs)


# ---------------------------------------------------------------------------
# Cache accounting and persistence.
# ---------------------------------------------------------------------------
def test_cache_hit_miss_accounting_is_consistent(svc):
    svc.submit(_req("random", eps=200, seed=1)).result(timeout=300)
    s1 = svc.stats()
    assert s1["cache_hits"] + s1["cache_misses"] == s1["unique_points"]
    assert s1["cache_misses"] == s1["fresh_points"] > 0
    assert s1["cache_entries"] == s1["cache_misses"]  # nothing evicted
    # Resubmitting the identical query evaluates nothing fresh.
    svc.submit(_req("random", eps=200, seed=1)).result(timeout=300)
    s2 = svc.stats()
    assert s2["cache_misses"] == s1["cache_misses"]
    assert s2["fresh_points"] == s1["fresh_points"]
    assert s2["cache_hits"] > s1["cache_hits"]
    assert s2["cache_hit_rate"] > s1["cache_hit_rate"]


def test_cache_shared_across_objectives(svc):
    """The point key excludes the objective: latency and energy users on
    the same workload reuse each other's evaluations."""
    svc.submit(_req("random", eps=200, seed=2)).result(timeout=300)
    misses = svc.stats()["cache_misses"]
    env2 = env_lib.EnvConfig(platform="cloud", objective="energy",
                             constraint="power")
    svc.submit(api.SearchRequest(workload="ncf", env=env2, eps=200, seed=2,
                                 method="random", device="cpu")
               ).result(timeout=300)
    assert svc.stats()["cache_misses"] == misses


def test_cache_lru_eviction_accounting():
    cache = CostMemoCache(capacity=4, version="v")
    keys = [bytes([i]) for i in range(6)]
    vals = np.arange(24, dtype=np.float32).reshape(6, 4)
    cache.put_many(keys, list(vals))
    assert len(cache) == 4 and cache.evictions == 2
    values, miss = cache.get_many(keys)
    assert miss == [0, 1]                      # oldest two evicted
    np.testing.assert_array_equal(values[5], vals[5])
    assert cache.hits == 4 and cache.misses == 2
    assert cache.stats()["hit_rate"] == pytest.approx(4 / 6)
    with pytest.raises(ValueError, match="capacity"):
        CostMemoCache(capacity=0)


def test_cache_version_is_the_ports_cost_model_hash():
    from repro_torch.costmodel import maestro

    assert CostMemoCache().version == maestro.content_hash()


def test_persistent_cache_round_trip(tmp_path):
    d = str(tmp_path / "cache")
    keys = [np.arange(i, i + 3, dtype=np.float32).tobytes()
            for i in range(10)]
    vals = [np.arange(4, dtype=np.float32) + i for i in range(10)]
    c = PersistentCostCache(d, version="v1", flush_every=1000)
    c.put_many(keys, vals)
    assert c.stats()["pending_flush"] == 10      # buffered, not yet on disk
    c.close()
    assert c.stats()["pending_flush"] == 0 and c.persisted == 10
    c2 = PersistentCostCache(d, version="v1")
    assert len(c2) == 10 and c2.shards_loaded == 1
    values, miss = c2.get_many(keys)
    assert miss == [] and c2.hit_rate == 1.0
    for v, want in zip(values, vals):
        np.testing.assert_array_equal(v, want)
    c2.put_many(keys, vals)             # loaded entries are not fresh
    assert c2.stats()["pending_flush"] == 0
    c2.close()


def test_persistent_cache_version_invalidates(tmp_path):
    d = str(tmp_path / "cache")
    keys = [bytes([i, i + 1]) for i in range(4)]
    vals = [np.full(4, i, np.float32) for i in range(4)]
    c = PersistentCostCache(d, version="model-a")
    c.put_many(keys, vals)
    c.close()
    other = PersistentCostCache(d, version="model-b")
    assert len(other) == 0 and other.shards_loaded == 0
    _, miss = other.get_many(keys)
    assert miss == list(range(4))
    other.close()


def test_persistent_cache_skips_corrupt_shards(tmp_path):
    d = str(tmp_path / "cache")
    keys = [bytes([i, i, i]) for i in range(6)]
    vals = [np.full(4, float(i), np.float32) for i in range(6)]
    c = PersistentCostCache(d, version="v1")
    c.put_many(keys[:3], vals[:3])
    c.flush()
    c.put_many(keys[3:], vals[3:])
    c.flush()
    c.close()
    shard_dir = os.path.join(d, "v1")
    shards = sorted(n for n in os.listdir(shard_dir) if n.endswith(".bin"))
    assert len(shards) == 2
    victim = os.path.join(shard_dir, shards[0])
    with open(victim, "rb") as f:
        blob = f.read()
    with open(victim, "wb") as f:
        f.write(blob[:-5])                      # truncated mid-body
    with open(os.path.join(shard_dir, "shard-999-000000.bin"), "wb") as f:
        f.write(b"not a shard at all")
    c2 = PersistentCostCache(d, version="v1")
    assert c2.corrupt_shards == 2
    assert c2.shards_loaded == 1 and len(c2) == 3
    values, miss = c2.get_many(keys)
    assert len(miss) == 3
    for i in (3, 4, 5):
        np.testing.assert_array_equal(values[i], vals[i])
    c2.close()


def test_service_warm_restart_serves_fully_from_disk(tmp_path):
    d = str(tmp_path / "cache")
    s1 = _svc(max_workers=2, cache_dir=d)
    try:
        want = s1.submit(_req("random", eps=200, seed=5)).result(timeout=300)
        assert s1.stats()["fresh_points"] > 0
        assert isinstance(s1.cache, PersistentCostCache)
    finally:
        s1.close()          # final flush happens here
    s2 = _svc(max_workers=2, cache_dir=d)
    try:
        assert len(s2.cache) > 0
        got = s2.submit(_req("random", eps=200, seed=5)).result(timeout=300)
        st = s2.stats()
        assert st["cache_misses"] == 0 and st["fresh_points"] == 0
        assert st["cache_hit_rate"] == 1.0
        _assert_same(got, want)
    finally:
        s2.close()


# ---------------------------------------------------------------------------
# Cancellation.
# ---------------------------------------------------------------------------
def _wait_for(cond, timeout=120):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


def test_cancel_queued_ticket_never_runs():
    s = _svc(max_workers=1)
    try:
        blocker = s.submit(_req("random", eps=3000, seed=0))
        queued = s.submit(_req("random", eps=150, seed=1))
        t0 = time.time()
        queued.cancel()          # still waiting behind the 1-worker pool
        with pytest.raises(SearchCancelled):
            queued.result(timeout=5)
        assert time.time() - t0 < 5.0
        assert queued.status == "cancelled" and queued.trials == []
        blocker.result(timeout=300)
        st = s.stats()
        assert st["cancelled"] == 1 and st["completed"] == 1
    finally:
        s.close()


def test_cancel_running_ga_within_one_chunk(svc):
    """An effectively unbounded GA stops within one chunk of the cancel
    (each generation's fitness call is a cancellation point too)."""
    got = []
    t = svc.submit(_req("ga", eps=10_000_000, progress_every=40,
                        on_progress=got.append, options={"population": 20}))
    assert _wait_for(lambda: got), "no progress streamed before deadline"
    t.cancel()
    at_cancel = t.trials[-1].step
    with pytest.raises(SearchCancelled):
        t.result(timeout=120)
    assert t.status == "cancelled"
    assert t.trials[-1].step <= at_cancel + 2 * 40
    # The batcher keeps serving everyone else.
    late = svc.submit(_req("grid", eps=150)).result(timeout=120)
    assert late.eps == 150
    st = svc.stats()
    assert st["cancelled"] == 1 and st["completed"] == 1


# ---------------------------------------------------------------------------
# Ticket and service lifecycle.
# ---------------------------------------------------------------------------
def test_closed_service_rejects_submissions():
    s = _svc(max_workers=1)
    s.close()
    with pytest.raises(RuntimeError, match="closed"):
        s.submit(_req("random"))


def test_failed_request_reports_error_and_does_not_hang(svc):
    t = svc.submit(_req("random", eps=100, wl="no_such_workload"))
    with pytest.raises(ValueError, match="no_such_workload"):
        t.result(timeout=120)
    assert t.status == "failed"
    # Each caller gets its own copy, chained to the stored error.
    try:
        t.result(timeout=1)
    except ValueError as e:
        assert e is not t._error and e.__cause__ is t._error
    assert svc.stats()["failed"] == 1


def test_request_on_another_device_fails_its_ticket(svc):
    t = svc.submit(_req("random", eps=100, device="cuda"))
    with pytest.raises(ValueError, match="runs on cpu"):
        t.result(timeout=120)
    assert t.status == "failed"
    assert svc.stats()["points"] == 0          # it ran nowhere


def test_service_on_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SearchService()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CostEvalBatcher()


def test_progress_recorded_on_ticket(svc):
    t = svc.submit(_req("reinforce", eps=60))
    t.result(timeout=300)
    steps = [tr.step for tr in t.trials]
    assert steps and steps == sorted(steps) and steps[-1] == 60


# ---------------------------------------------------------------------------
# Batcher internals.
# ---------------------------------------------------------------------------
def _ncf_env():
    return env_lib.make_env(workloads.get_workload("ncf"), ECFG, device="cpu")


def test_batcher_evaluate_equals_genome_cost_bitwise():
    env = _ncf_env()
    rng = np.random.default_rng(0)
    g = rng.integers(0, ECFG.levels, size=(64, env.num_layers, 2))
    want, pe, kt = baselines._decode_and_eval(env, ECFG, torch.from_numpy(g))
    layers = env.layers.numpy()
    b = CostEvalBatcher(window_ms=0.0, device="cpu")
    try:
        args = (layers, pe.numpy(), kt.numpy(), np.float32(ECFG.dataflow),
                ECFG, env.budget.numpy())
        got = b.evaluate(*args)
        assert got.tobytes() == want.numpy().tobytes()
        again = b.evaluate(*args)             # served from the cache
        assert again.tobytes() == got.tobytes()
        st = b.stats()
        assert st["fresh_points"] == st["cache_misses"] > 0
        assert st["cache_hits"] > 0
    finally:
        b.close()


def test_one_dispatch_of_mixed_items_equals_serial_bitwise():
    """One dispatch carries items of two workloads with different N, under
    two objectives, some all cached and some fresh: each item's fitness is
    the serial genome_cost's, byte for byte, and the cache stores each
    fresh point's four costs under the bytes of its packed row."""
    from repro_torch.serving.batcher import _Item

    rng = np.random.default_rng(5)
    cases = []
    for wl, objective in (("ncf", "latency"), ("mobilenet_v2", "energy")):
        ecfg = env_lib.EnvConfig(objective=objective, platform="cloud")
        env = env_lib.make_env(workloads.get_workload(wl), ecfg,
                               device="cpu")
        for b in (3, 5):
            g = torch.from_numpy(rng.integers(0, ecfg.levels,
                                              (b, env.num_layers, 2)))
            cases.append((env, ecfg,
                          *baselines._decode_and_eval(env, ecfg, g)))

    def items(sel):
        return [_Item(pack_point_rows(env.layers.numpy(), pe.numpy(),
                                      kt.numpy(), np.float32(ecfg.dataflow)),
                      tuple(pe.shape), ecfg, np.float32(env.budget.numpy()))
                for env, ecfg, _, pe, kt in (cases[i] for i in sel)]

    b = CostEvalBatcher(window_ms=0.0, device="cpu")
    try:
        b._dispatch(items([0, 2]))                 # cache two items' points
        fresh_before = b.stats()["fresh_points"]
        mixed = items(range(4))                    # 0, 2 cached; 1, 3 fresh
        b._dispatch(mixed)
        st = b.stats()
        assert st["dispatches"] == 2 and st["fused_dispatches"] == 2
        assert st["fresh_points"] > fresh_before
        rows = np.concatenate([it.points for it in mixed])
        vals, missing = b.cache.get_many([r.tobytes() for r in rows])
        assert missing == []
        assert np.stack(vals).tobytes() == eval_point_rows(
            rows, torch.device("cpu")).tobytes()
    finally:
        b.close()
    for it, (_, _, want, _, _) in zip(mixed, cases):
        assert it.fit.dtype == np.float32
        assert it.fit.tobytes() == want.numpy().tobytes()


def test_batcher_close_fails_pending_when_dispatch_hangs():
    b = CostEvalBatcher(window_ms=0.0, dispatch_workers=1,
                        join_timeout_s=0.2, device="cpu")
    entered = threading.Event()
    release = threading.Event()

    def stuck_dispatch(items):
        entered.set()
        release.wait(60)            # a wedged device dispatch
        for it in items:
            it.error = RuntimeError("released")
            it.event.set()

    b._dispatch = stuck_dispatch
    errs = {}

    def submit(name):
        try:
            b.evaluate(np.ones((1, NUM_FIELDS), np.float32),
                       np.ones((1, 1), np.float32),
                       np.ones((1, 1), np.float32), np.float32(0), ECFG,
                       np.float32(1.0))
        except RuntimeError as e:
            errs[name] = e

    ta = threading.Thread(target=submit, args=("hung",))
    ta.start()
    assert entered.wait(timeout=60)
    tb = threading.Thread(target=submit, args=("stranded",))
    tb.start()
    assert _wait_for(lambda: bool(b._pending), 60)
    b.close()
    assert b.stats()["leaked_dispatch_threads"] == 1
    tb.join(timeout=60)
    assert not tb.is_alive()
    assert "hung dispatch" in str(errs["stranded"])
    release.set()
    ta.join(timeout=60)
    assert not ta.is_alive()
    assert "released" in str(errs["hung"])


def test_batcher_clean_close_and_closed_rejects():
    b = CostEvalBatcher(dispatch_workers=2, device="cpu")
    b.close()
    assert b.stats()["leaked_dispatch_threads"] == 0
    with pytest.raises(RuntimeError, match="closed"):
        b.evaluate(np.ones((1, NUM_FIELDS), np.float32),
                   np.ones((1, 1), np.float32), np.ones((1, 1), np.float32),
                   np.float32(0), ECFG, np.float32(1.0))


def test_point_rows_cover_all_fields_and_never_collide():
    assert ROW_WIDTH == NUM_FIELDS + 3
    a = layers_to_array([LayerSpec.gemm(64, 64, 64)])
    c = layers_to_array([LayerSpec.conv(16, 16, 14, 14, 3, 3)])
    pe, kt, df = (np.asarray([[v]], np.float32) for v in (32.0, 4.0, 0.0))
    assert pack_point_rows(a, pe, kt, df).tobytes() != pack_point_rows(
        c, pe, kt, df).tobytes()
    b = CostEvalBatcher(device="cpu")
    try:
        fa = b.evaluate(a, pe, kt, df, ECFG, 1e18)
        fc = b.evaluate(c, pe, kt, df, ECFG, 1e18)
        assert len(b.cache) == 2 and b.cache.misses == 2
        assert fa[0] != fc[0]
    finally:
        b.close()


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------
def _cli_summary(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", **ONE_THREAD)
    proc = subprocess.run([sys.executable, "-m", module, *args], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_serve_search_cli_prints_the_reference_summary_keys():
    args = ("--workloads", "ncf", "--methods", "random,grid,ga", "--n", "6",
            "--eps", "200")
    got = _cli_summary("repro_torch.launch.serve_search", *args,
                       "--device", "cpu")
    want = _cli_summary("repro.launch.serve_search", *args)
    assert list(got) == list(want)
    assert got["requests"] == 6 and got["dispatches"] > 0
    assert 0.0 < got["points_eliminated_frac"] <= 1.0
