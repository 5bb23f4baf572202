"""Registry-wide telemetry conformance of the port on the CPU.

For every method the port registers, at the sizes of
tests/test_optimizer_conformance.py's ``CASES``:

  * telemetry is observational -- the same request with
    ``repro_torch.obs`` on and off gives byte-identical outcomes (best
    value, history, assignment, frontier);
  * the flight recorder names the method (``telemetry["engine"]``);
  * its accounting equals the JAX package's for the same request: the
    hard evaluations and chunks a search consumes are bookkeeping of the
    request, not random draws, so they match exactly.

Also here: ``run_local_ga``'s ``eval_fn`` (the same bits as the in-graph
fitness; ``eval_fn`` receives the frozen ``init_df``), the chunk spans,
and the launchers' ``--trace-out`` / ``--metrics-out`` / ``--profile``.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro import obs as ref_obs
from repro.core import env as ref_env
from repro_torch import api, obs
from repro_torch.core import env as env_lib
from repro_torch.core import ga as ga_lib
from repro_torch.costmodel import workloads
from repro_torch.serving import batcher as batcher_lib

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_optimizer_conformance import CASES as REF_CASES  # noqa: E402
from torch_threads import ONE_THREAD, one_torch_thread  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ECFG = env_lib.EnvConfig(platform="cloud")
METHODS = ("a2c", "bo", "dist_reinforce", "fanout", "ga", "grid", "nsga2",
           "ppo2", "random", "reinforce", "relaxed", "sa", "two_stage")
CASES = {m: REF_CASES[m] for m in METHODS}


@pytest.fixture(autouse=True)
def _clean_obs():
    for o in (obs, ref_obs):
        o.disable()
        o.reset()
    yield
    for o in (obs, ref_obs):
        o.disable()
        o.reset()


def _req(method, **kw):
    eps, options = CASES[method]
    return api.SearchRequest(workload="ncf", env=ECFG, eps=eps, seed=7,
                             method=method, options=dict(options),
                             device="cpu", **kw)


def _ref_telemetry(method):
    eps, options = CASES[method]
    ref_obs.enable(trace=True)
    try:
        out = ref_api.run_search(ref_api.SearchRequest(
            workload="ncf", env=ref_env.EnvConfig(platform="cloud"), eps=eps,
            seed=7, method=method, options=dict(options)))
    finally:
        ref_obs.disable()
    return out.telemetry


def _frontier_bytes(out):
    if out.frontier is None:
        return None
    return {k: np.asarray(v).tobytes() for k, v in out.frontier.items()}


def test_every_port_method_has_a_case():
    assert set(METHODS) == set(api.list_optimizers())


@pytest.mark.parametrize("method", METHODS)
def test_telemetry_is_observational_and_accounts_like_the_reference(method):
    plain = api.run_search(_req(method))
    obs.enable(trace=True)
    try:
        traced = api.run_search(_req(method))
    finally:
        obs.disable()

    assert plain.best_value == traced.best_value
    assert plain.history.tobytes() == traced.history.tobytes()
    assert plain.pe.tobytes() == traced.pe.tobytes()
    assert plain.kt.tobytes() == traced.kt.tobytes()
    assert plain.df.tobytes() == traced.df.tobytes()
    assert _frontier_bytes(plain) == _frontier_bytes(traced)
    assert plain.telemetry is None
    t = traced.telemetry
    assert t is not None and t["engine"] == method
    assert t.get("hard_evals", 0) > 0, t

    want = _ref_telemetry(method)
    assert want["engine"] == method
    assert t["hard_evals"] == want["hard_evals"]
    assert t.get("chunks") == want.get("chunks")
    if "chunks" in t:
        # One search.chunk span per chunk, inside the search.run span.
        spans = obs.tracer().spans()
        chunks = [s for s in spans if s["name"] == "search.chunk"]
        assert len(chunks) == t["chunks"]
        assert all(s["parent"] in ("search.run", "search.chunk")
                   for s in chunks)
        assert sum(s["attrs"]["evals"] for s in chunks) == t["hard_evals"]


# ---------------------------------------------------------------------------
# run_local_ga's eval_fn.
# ---------------------------------------------------------------------------
def _local_ga_setup():
    env = env_lib.make_env(workloads.get_workload("ncf"), ECFG, "cpu")
    N = env.num_layers
    rng = np.random.default_rng(5)
    init_pe = env.pe_table[torch.as_tensor(rng.integers(0, 4, N))]
    init_kt = env.kt_table[torch.as_tensor(rng.integers(0, 4, N))]
    init_df = np.array([0, 1, 2, 0, 1][:N] + [0] * max(N - 5, 0))
    cfg = ga_lib.LocalGAConfig(population=16, generations=12, seed=3)
    return env, init_pe, init_kt, init_df, cfg


def test_local_ga_eval_fn_gives_the_same_bits():
    """Stage 2 with its fitness through ``make_local_costs_eval`` (the
    per-row programs a batcher dispatch runs) equals the in-graph run."""
    env, pe, kt, df, cfg = _local_ga_setup()
    costs_eval = batcher_lib.make_local_costs_eval(env, ECFG)
    seen = []

    def eval_fn(p, k, d):
        seen.append(np.array(d, copy=True))
        c = torch.from_numpy(costs_eval(p, k, d))
        perf = env_lib.select_objective(c[:, 0], c[:, 1], ECFG)
        cons = c[:, 2] if ECFG.constraint == "area" else c[:, 3]
        return torch.where(cons <= env.budget, perf, torch.inf).numpy()

    want, whist = ga_lib.run_local_ga(None, ECFG, pe, kt, df, cfg, env=env,
                                      chunk=5, device="cpu")
    got, ghist = ga_lib.run_local_ga(None, ECFG, pe, kt, df, cfg, env=env,
                                     chunk=5, eval_fn=eval_fn, device="cpu")
    assert ghist.tobytes() == whist.tobytes()
    assert float(got.best_val) == float(want.best_val)
    assert torch.equal(got.best_genome, want.best_genome)
    assert torch.equal(got.pop, want.pop)
    assert len(seen) == cfg.generations
    frozen = np.asarray(df, np.float32)
    for d in seen:                    # the frozen init_df, every generation
        assert d.dtype == np.float32 and d.tobytes() == frozen.tobytes()


def test_local_ga_counts_its_hard_evals():
    env, pe, kt, df, cfg = _local_ga_setup()
    obs.enable(trace=True)
    rec = obs.FlightRecorder(engine="local_ga")
    with obs.recording(rec):
        ga_lib.run_local_ga(None, ECFG, pe, kt, df, cfg, env=env, chunk=5,
                            device="cpu")
    s = rec.summary()
    assert s["chunks"] == 3                       # 5 + 5 + 2 generations
    assert s["hard_evals"] == cfg.population * cfg.generations
    assert obs.instrument.SEARCH_HARD_EVALS.value(engine="local_ga") == \
        cfg.population * cfg.generations


# ---------------------------------------------------------------------------
# Launchers.
# ---------------------------------------------------------------------------
def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               **ONE_THREAD)
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _checker():
    spec = importlib.util.spec_from_file_location(
        "check_telemetry", os.path.join(REPO, "tools", "check_telemetry.py"))
    checker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(checker)
    return checker


def test_search_cli_writes_checkable_telemetry(tmp_path):
    trace, prom = tmp_path / "trace.jsonl", tmp_path / "metrics.prom"
    out = tmp_path / "out.json"
    r = _run(["repro_torch.launch.search", "--workload", "ncf", "--method",
              "ga", "--epochs", "200", "--platform", "cloud", "--device",
              "cpu", "--trace-out", str(trace), "--metrics-out", str(prom),
              "--out", str(out)])
    assert r.returncode == 0, r.stderr
    assert "telemetry: hard_evals=200" in r.stdout
    checker = _checker()
    assert checker.check_trace(str(trace), ["search.run", "search.chunk"])
    assert checker.check_metrics(str(prom), ["repro_search_hard_evals",
                                             "repro_search_chunks"])
    rec = json.loads(out.read_text())
    assert rec["telemetry"]["engine"] == "ga"
    assert rec["telemetry"]["hard_evals"] == 200


def test_search_cli_is_unchanged_by_profile(tmp_path):
    last = []
    for extra in ([], ["--profile"]):
        r = _run(["repro_torch.launch.search", "--workload", "ncf",
                  "--method", "sa", "--epochs", "120", "--platform",
                  "cloud", "--device", "cpu", *extra])
        assert r.returncode == 0, r.stderr
        line = json.loads(r.stdout.strip().splitlines()[-1])
        line.pop("wall_seconds")
        last.append((line, "telemetry:" in r.stdout))
    assert last[0][0] == last[1][0]
    assert [p for _, p in last] == [False, True]


def test_serve_search_cli_profile_rows(tmp_path):
    prom, out = tmp_path / "m.json", tmp_path / "serve.json"
    r = _run(["repro_torch.launch.serve_search", "--device", "cpu",
              "--workloads", "ncf", "--methods", "random,ga", "--n", "4",
              "--eps", "120", "--metrics-out", str(prom), "--out", str(out)])
    assert r.returncode == 0, r.stderr
    rows = json.loads(out.read_text())["results"]
    assert len(rows) == 4
    for row in rows:
        t = row["telemetry"]
        assert t["engine"] == row["method"]
        # ga spends whole generations of its population within eps.
        assert (t["hard_evals"] == 120 if row["method"] == "random"
                else 0 < t["hard_evals"] <= 120)
        assert t["points"] > 0 and "queue_wait_s" in t
    snap = json.loads(prom.read_text())
    assert snap["repro_service_requests"]["values"]["completed"] == 4.0
