"""The port's seed-parallel ``fanout`` on the CPU, against the JAX package.

Whole searches of the two packages cannot match seed for seed (their
random streams differ), so the merge is held to the reference's on the
same shard outcomes: a deterministic stub inner, registered under one
test-only name in both registries, returns a fixed outcome per seed (ties
included).  The port's backends are held to its own ``serial`` loop byte
for byte (``device`` runs its shards in lockstep on the CPU), and every
entry of ``results/search_quality_ref.json`` (the JAX package's arm of
the search-quality check) re-scores under the port's cost model.
"""
import json
import os

import numpy as np
import pytest

from repro.api import registry as ref_registry
from repro.api import types as ref_types
from repro.distributed import dist_search as ref_dist
from repro_torch import api
from repro_torch.api import registry, types
from repro_torch.core import env as env_lib
from repro_torch.costmodel import workloads
from repro_torch.distributed import dist_search
from repro_torch.launch import search as search_cli
from repro_torch.serving import (HttpConfig, SearchClient, SearchHTTPService,
                                 ServiceConfig)
from torch_threads import one_torch_thread  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY_REF = os.path.join(REPO, "results", "search_quality_ref.json")
ECFG = env_lib.EnvConfig(platform="cloud")
STUB = "_fanout_test_stub"
N_NCF = 5
# Per seed: (best value, first sample index at which it shows).  Seeds 2
# and 3 tie on the best; seed 5 never finds a feasible point.
STUB_RUNS = {0: (9.0, 3), 1: (7.5, 11), 2: (4.25, 6), 3: (4.25, 2),
             4: (6.0, 0), 5: (float("inf"), 0)}


def _stub_class(types_mod):
    """An optimizer whose outcome depends only on the seed, built through
    ``types_mod``'s own ``build_outcome`` (so its progress replays too)."""

    class Stub:
        name = STUB

        def run(self, request):
            best, at = STUB_RUNS[request.seed % len(STUB_RUNS)]
            trace = np.full(request.eps, np.inf)
            if np.isfinite(best):
                trace[at:] = best * (1 + np.arange(request.eps - at)[::-1]
                                     / request.eps)
            rng = np.random.default_rng(request.seed)
            pe = rng.integers(1, 64, N_NCF).astype(np.float32)
            kt = rng.integers(1, 12, N_NCF).astype(np.float32)
            df = rng.integers(0, 3, N_NCF)
            return types_mod.build_outcome(request, self.name, best, pe, kt,
                                           df, trace, 0.0)

    return Stub


@pytest.fixture
def stub_registered():
    """The stub under ``STUB`` in both registries, for this test only."""
    registry.list_optimizers()          # load the plugins first
    ref_registry.list_optimizers()
    registry.register(STUB)(_stub_class(types))
    ref_registry.register(STUB)(_stub_class(ref_types))
    try:
        yield
    finally:
        registry._FACTORIES.pop(STUB, None)
        ref_registry._FACTORIES.pop(STUB, None)


def _fanout(inner, backend, eps, n_shards=3, inner_options=None, seed=5,
            **kw):
    return api.SearchRequest(
        workload="ncf", env=ECFG, eps=eps, seed=seed, method="fanout",
        options={"inner": inner, "n_shards": n_shards, "backend": backend,
                 "inner_options": dict(inner_options or {})},
        device="cpu", **kw)


def _assert_same(a, b, extras=True):
    assert a.best_value == b.best_value
    assert a.history.tobytes() == b.history.tobytes()
    for k in ("pe", "kt", "df"):
        assert getattr(a, k).tobytes() == getattr(b, k).tobytes(), k
    if extras:
        drop = lambda e: {k: v for k, v in e.items() if k != "backend"}
        assert drop(a.extras) == drop(b.extras)


# ---------------------------------------------------------------------------
# The merge, against the reference's.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,n_shards", [(0, 4), (2, 2), (0, 6), (5, 1)])
def test_merge_equals_the_references_on_the_same_shard_outcomes(
        stub_registered, seed, n_shards):
    from repro import api as ref_api

    got_trials, want_trials = [], []
    opts = {"inner": STUB, "n_shards": n_shards, "backend": "serial"}
    got = api.run_search(api.SearchRequest(
        workload="ncf", env=ECFG, eps=40, seed=seed, method="fanout",
        options=dict(opts), device="cpu", on_progress=got_trials.append,
        progress_every=7))
    want = ref_api.run_search(ref_api.SearchRequest(
        workload="ncf", env=ref_api.EnvConfig(platform="cloud"), eps=40,
        seed=seed, method="fanout", options=dict(opts),
        on_progress=want_trials.append, progress_every=7))
    assert got.method == want.method == "fanout"
    assert got.best_value == want.best_value
    assert got.history.tobytes() == want.history.tobytes()
    for k in ("pe", "kt", "df"):
        assert np.asarray(getattr(got, k)).tobytes() == \
            np.asarray(getattr(want, k)).tobytes(), k
    assert got.extras == want.extras
    assert got.samples_to_convergence == want.samples_to_convergence
    assert got_trials == [types.Trial(*t) for t in want_trials]
    if seed == 2 and n_shards == 2:     # seeds 2 and 3 tie: the first wins
        assert got.extras["best_seed"] == 2


def test_progress_merge_tags_like_the_references():
    seq = [(1, 10, 9.0, 9.0), (0, 10, 12.0, 12.0), (1, 20, 7.0, 7.0),
           (2, 5, float("inf"), float("inf")), (0, 20, 6.5, 6.5),
           (2, 10, 8.0, 8.0), (1, 30, 7.5, 7.0)]
    got, want = [], []
    mine = dist_search._MergedProgress(got.append, 3)
    ref = ref_dist._MergedProgress(want.append, 3)
    for s, step, value, best in seq:
        mine.shard_cb(s)(types.Trial(step, value, best))
        ref.shard_cb(s)(ref_types.Trial(step, value, best))
    assert got == [types.Trial(*t) for t in want]
    assert [t.shard for t in got] == [s for s, *_ in seq]
    assert got[-1].best_value == 6.5
    assert dist_search._MergedProgress(None, 2).shard_cb(0) is None


# ---------------------------------------------------------------------------
# Backends: the same bytes as serial.
# ---------------------------------------------------------------------------
BACKEND_CASES = [("random", "threads", 120, {}),
                 ("sa", "threads", 60, {}),
                 ("reinforce", "threads", 12, {}),
                 ("reinforce", "device", 12, {}),
                 ("ga", "device", 200, {"population": 20})]


@pytest.mark.parametrize("inner,backend,eps,opts", BACKEND_CASES)
def test_backend_gives_the_bytes_of_serial(inner, backend, eps, opts):
    serial = api.run_search(_fanout(inner, "serial", eps, inner_options=opts))
    got = api.run_search(_fanout(inner, backend, eps, inner_options=opts))
    assert got.extras["backend"] == backend
    assert serial.extras["backend"] == "serial"
    _assert_same(got, serial)
    assert any(np.isfinite(serial.extras["shard_best_values"]))


@pytest.mark.parametrize("inner,eps,opts", [("reinforce", 12, {}),
                                            ("ga", 200, {"population": 20})])
def test_device_shards_equal_their_serial_inner_runs(inner, eps, opts):
    """Each shard of the device backend equals the inner method run alone
    with its seed: outcome, and the inner's own extras."""
    subs = [api.SearchRequest(workload="ncf", env=ECFG, eps=eps, seed=3 + s,
                              method=inner, options=dict(opts),
                              device="cpu") for s in range(2)]
    shards = dist_search._DEVICE_ENGINES[inner](subs)
    for sub, got in zip(subs, shards):
        want = api.run_search(sub)
        _assert_same(got, want, extras=False)
        assert got.extras.keys() == want.extras.keys()
        if inner == "reinforce":
            for k, v in want.extras["history"].items():
                assert got.extras["history"][k].tobytes() == v.tobytes(), k


def test_fanout_extras_and_merge():
    out = api.run_search(_fanout("random", "serial", 80, n_shards=3))
    e = out.extras
    assert e["inner"] == "random" and e["n_shards"] == 3
    assert e["total_samples"] == 3 * 80
    assert len(e["shard_best_values"]) == 3
    assert out.best_value == min(e["shard_best_values"])
    assert e["best_seed"] == 5 + int(np.argmin(e["shard_best_values"]))
    singles = [api.run_search(api.SearchRequest(
        workload="ncf", env=ECFG, eps=80, seed=5 + s, method="random",
        device="cpu")) for s in range(3)]
    assert [o.best_value for o in singles] == e["shard_best_values"]
    trace = np.min(np.stack([o.history for o in singles]), axis=0)
    assert out.history.tobytes() == trace.tobytes()


# ---------------------------------------------------------------------------
# Streaming.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["serial", "device", "threads"])
def test_progress_is_shard_tagged_and_monotone(backend):
    trials = []
    out = api.run_search(_fanout("reinforce", backend, 12,
                                 on_progress=trials.append,
                                 progress_every=4))
    by_shard = {}
    for t in trials:
        assert t.shard in (0, 1, 2) and 1 <= t.step <= 12
        by_shard.setdefault(t.shard, []).append(t)
    assert sorted(by_shard) == [0, 1, 2]
    for ts in by_shard.values():
        steps = [t.step for t in ts]
        assert steps == sorted(steps) and steps[-1] == 12
    ensemble = [t.best_value for t in trials]
    assert all(b <= a for a, b in zip(ensemble, ensemble[1:]))
    assert ensemble[-1] == out.best_value
    # Streaming changes nothing else.
    _assert_same(out, api.run_search(_fanout("reinforce", backend, 12)))


def test_threads_merge_progress_under_contention():
    """More worker threads than cores and a short switch interval: every
    shard's stream arrives whole, the last Trial carries the ensemble
    best, and the outcome equals serial's."""
    import sys

    trials = []
    n_shards = (os.cpu_count() or 1) + 4
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = api.run_search(_fanout("random", "threads", 40,
                                     n_shards=n_shards,
                                     on_progress=trials.append,
                                     progress_every=5))
    finally:
        sys.setswitchinterval(old)
    for s in range(n_shards):
        steps = [t.step for t in trials if t.shard == s]
        assert steps == list(range(5, 41, 5)), s
    assert trials[-1].best_value == out.best_value
    _assert_same(out, api.run_search(_fanout("random", "serial", 40,
                                             n_shards=n_shards)))


def test_device_streams_each_shard_as_serial_does():
    got, want = [], []
    api.run_search(_fanout("reinforce", "device", 12, on_progress=got.append,
                           progress_every=4))
    api.run_search(_fanout("reinforce", "serial", 12, on_progress=want.append,
                           progress_every=4))
    per_shard = lambda ts: {s: [(t.step, t.value) for t in ts if t.shard == s]
                            for s in range(3)}
    assert per_shard(got) == per_shard(want)


# ---------------------------------------------------------------------------
# Errors and the backend rule.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("options,match", [
    ({"inner": "fanout"}, "cannot nest"),
    ({"inner": "random", "n_shards": 0}, "n_shards"),
    ({"inner": "random", "backend": "gpu"}, "unknown fanout backend"),
    ({"inner": "sa", "backend": "device"}, "backend='device'"),
])
def test_bad_requests_raise(options, match):
    with pytest.raises(ValueError, match=match):
        api.run_search(api.SearchRequest(
            workload="ncf", env=ECFG, eps=10, method="fanout",
            options=options, device="cpu"))


def test_auto_backend_rule():
    resolve = dist_search._resolve_backend
    assert resolve("auto", "reinforce", "cuda") == "device"
    assert resolve("auto", "ga", "cuda:0") == "device"
    assert resolve("auto", "reinforce", "cpu") == "threads"
    assert resolve("auto", "sa", "cuda") == "threads"
    assert resolve("device", "ga", "cpu") == "device"
    out = api.run_search(_fanout("random", "auto", 30, n_shards=2))
    assert out.extras["backend"] == "threads"


@pytest.mark.parametrize("inner,backend", [("reinforce", "device"),
                                           ("ga", "device"),
                                           ("sa", "threads")])
def test_cuda_request_without_a_card_raises(inner, backend):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    req = _fanout(inner, backend, 4)
    req.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.run_search(req)


# ---------------------------------------------------------------------------
# CLI and HTTP.
# ---------------------------------------------------------------------------
def test_cli_fanout_writes_the_extras(tmp_path, capsys):
    out = tmp_path / "out.json"
    rc = search_cli.main(["--workload", "ncf", "--method", "fanout",
                          "--fanout-backend", "serial", "--fanout-shards",
                          "2", "--fanout-inner", "random", "--epochs", "60",
                          "--platform", "cloud", "--device", "cpu",
                          "--progress-every", "30", "--out", str(out)])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert any(" shard=1 " in ln for ln in lines)
    last = json.loads(lines[-2])          # the line before "wrote ..."
    assert last["method"] == "fanout"
    fan = last["fanout"]
    assert fan["backend"] == "serial" and fan["n_shards"] == 2
    assert fan["inner"] == "random" and fan["total_samples"] == 120
    assert len(fan["shard_best_values"]) == 2
    assert min(fan["shard_best_values"]) == last["best_value"]
    assert json.loads(out.read_text())["fanout"] == fan


def test_http_fanout_progress_lines_carry_the_shard():
    hub = SearchHTTPService(
        service_cfg=ServiceConfig(max_workers=1, default_progress_every=4,
                                  device="cpu"),
        http_cfg=HttpConfig(port=0, progress_poll_s=0.01)).start()
    try:
        client = SearchClient(port=hub.port, timeout=60.0)
        uid = client.submit({"workload": "ncf", "method": "fanout",
                             "eps": 12, "platform": "cloud",
                             "inner": "reinforce", "n_shards": 2,
                             "backend": "serial"})["uid"]
        recs = list(client.progress(uid))
        assert recs[-1] == {"status": "done", "done": True}
        trials = recs[:-1]
        assert {r["shard"] for r in trials} == {0, 1}
        out = client.result(uid, timeout=60.0)
        assert out["best_value"] == min(r["best_value"] for r in trials)
    finally:
        with hub.front._cv:
            uids = list(hub.front._jobs)
        for u in uids:
            hub.front.cancel(u)
        hub.close()


# ---------------------------------------------------------------------------
# The JAX package's arm of the search-quality check.
# ---------------------------------------------------------------------------
def _load_quality():
    with open(QUALITY_REF) as f:
        return json.load(f)


_QUALITY = _load_quality()


def test_quality_file_covers_ten_seeds_of_each_config():
    assert _QUALITY["workload"] == "mobilenet_v2"
    assert _QUALITY["seeds"] == list(range(10))
    for name in _QUALITY["configs"]:
        seeds = sorted(e["seed"] for e in _QUALITY["entries"]
                       if e["config"] == name)
        assert seeds == list(range(10)), name


@pytest.mark.parametrize(
    "entry", _QUALITY["entries"],
    ids=[f"{e['config']}-seed{e['seed']}" for e in _QUALITY["entries"]])
def test_quality_entry_rescores_under_the_ports_cost_model(entry):
    """Both arms optimise the same objective: the reference's best
    assignment scores its recorded best value under the port's cost model
    on the CPU (rtol 1e-5) and fits the port's budget."""
    if entry["best_value"] is None:
        pytest.skip("the reference found no feasible point on this seed")
    cfg = _QUALITY["configs"][entry["config"]]
    ecfg = env_lib.EnvConfig(platform=cfg["platform"], **_QUALITY["env"])
    env = env_lib.make_env(workloads.get_workload(_QUALITY["workload"]),
                           ecfg, "cpu")
    perf, cons, feas = env_lib.genome_cost(
        env, ecfg, np.asarray(entry["pe"], np.float32),
        np.asarray(entry["kt"], np.float32), np.asarray(entry["df"]))
    np.testing.assert_allclose(float(perf), entry["best_value"], rtol=1e-5)
    assert float(cons) <= float(env.budget) * (1 + 1e-6)
    assert entry["eps"] == cfg["eps"]
    assert 1 <= entry["samples_to_convergence"] <= entry["eps"]

