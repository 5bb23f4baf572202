"""The port's classic baselines against the JAX package's, on the CPU, and
the conformance contract over the port's registry.

Random draws differ between JAX and torch, so the baselines are held to
the reference by injection and by replay, not seed for seed:

  * grid and bo given the same numpy ``eval_fn`` give byte-identical
    histories and bests (grid is deterministic; bo draws from
    ``np.random.default_rng(seed)`` in both packages);
  * ``_decode_and_eval`` of the same numpy genomes agrees at rtol 1e-5
    (the cost model's bound, tests/test_torch_costmodel.py);
  * SA's ``accept`` replayed on the same state, candidate, fitness and
    uniform draw gives the same next state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import baselines as jbase
from repro.core import env as jenv
from repro.costmodel import workloads as jworkloads
from repro_torch import api as tapi
from repro_torch.core import baselines as tbase
from repro_torch.core import env as tenv
from repro_torch.costmodel import dataflows as tdfl
from repro_torch.costmodel import workloads as tworkloads
from torch_threads import one_torch_thread  # noqa: F401,E402

KW = dict(platform="cloud")


def _envs(name, **kw):
    return (tenv.make_env(tworkloads.get_workload(name), tenv.EnvConfig(**kw),
                          device="cpu"),
            jenv.make_env(jworkloads.get_workload(name),
                          jenv.EnvConfig(**kw)))


def _numpy_eval_fn(N, levels=12, seed=0):
    """A genome evaluator in plain numpy, the same in both packages: a
    weighted sum of the decoded values, +inf where a made-up budget is
    exceeded."""
    pe_t = tdfl.pe_levels(levels).astype(np.float32)
    kt_t = tdfl.kt_levels(levels).astype(np.float32)
    w = np.random.default_rng(seed).random(N).astype(np.float32)
    cap = np.float32(pe_t[levels // 2] * N)

    def eval_fn(genomes):
        g = np.asarray(genomes).astype(np.int64)
        pe, kt = pe_t[g[..., 0]], kt_t[g[..., 1]]
        fit = (pe * w).sum(-1) + kt.sum(-1) + np.float32(1.0)
        return (np.where(pe.sum(-1) > cap, np.float32(np.inf), fit)
                .astype(np.float32), pe, kt)

    return eval_fn


def _same_result(got, want):
    assert got.best_value == want.best_value
    assert got.history.tobytes() == np.asarray(want.history).tobytes()
    np.testing.assert_array_equal(got.best_pe, want.best_pe)
    np.testing.assert_array_equal(got.best_kt, want.best_kt)


@pytest.mark.parametrize("name,eps,kw", [
    ("ncf", 700, dict(batch=128)),
    ("mobilenet_v2", 300, dict(stride=3)),
])
def test_grid_with_injected_eval_fn_byte_identical_to_reference(name, eps,
                                                                kw):
    N = len(tworkloads.get_workload(name))
    got = tbase.grid_search(tworkloads.get_workload(name),
                            tenv.EnvConfig(**KW), eps=eps,
                            eval_fn=_numpy_eval_fn(N), device="cpu", **kw)
    want = jbase.grid_search(jworkloads.get_workload(name),
                             jenv.EnvConfig(**KW), eps=eps,
                             eval_fn=_numpy_eval_fn(N), **kw)
    _same_result(got, want)
    assert np.isfinite(got.best_value)


@pytest.mark.parametrize("name,eps,seed,kw", [
    ("ncf", 300, 0, {}),
    ("mnasnet", 200, 5, dict(init_random=32, batch=8, n_candidates=32)),
])
def test_bo_with_injected_eval_fn_byte_identical_to_reference(name, eps,
                                                              seed, kw):
    N = len(tworkloads.get_workload(name))
    got = tbase.bayes_opt(tworkloads.get_workload(name), tenv.EnvConfig(**KW),
                          eps=eps, seed=seed, eval_fn=_numpy_eval_fn(N, seed=1),
                          device="cpu", **kw)
    want = jbase.bayes_opt(jworkloads.get_workload(name),
                           jenv.EnvConfig(**KW), eps=eps, seed=seed,
                           eval_fn=_numpy_eval_fn(N, seed=1), **kw)
    _same_result(got, want)


@pytest.mark.parametrize("method", ["grid", "bo"])
def test_adapters_with_injected_eval_fn_byte_identical_to_reference(method):
    """The same through ``api.run_search`` of both packages."""
    N = len(tworkloads.get_workload("ncf"))
    mk = lambda api, **extra: api.SearchRequest(
        workload="ncf", env=api.EnvConfig(**KW), eps=250, seed=3,
        method=method, options={"eval_fn": _numpy_eval_fn(N)}, **extra)
    got = tapi.run_search(mk(tapi, device="cpu"))
    want = japi.run_search(mk(japi))
    assert got.best_value == want.best_value
    assert got.history.tobytes() == want.history.tobytes()
    np.testing.assert_array_equal(got.pe, want.pe)
    np.testing.assert_array_equal(got.kt, want.kt)
    np.testing.assert_array_equal(got.df, want.df)


@pytest.mark.parametrize("name,kw", [
    ("ncf", dict(platform="iot")),
    ("mobilenet_v2", dict(platform="cloud", scenario="LS", objective="energy",
                          constraint="power", dataflow=2)),
])
def test_decode_and_eval_matches_reference(name, kw):
    env_t, env_j = _envs(name, **kw)
    rng = np.random.default_rng(6)
    g = rng.integers(0, 12, (64, env_t.num_layers, 2))
    g[:32] //= 4                        # small designs: some fit the budget
    fit_t, pe_t, kt_t = tbase._decode_and_eval(env_t, tenv.EnvConfig(**kw),
                                               torch.from_numpy(g))
    fit_j, pe_j, kt_j = jbase._decode_and_eval(env_j, jenv.EnvConfig(**kw),
                                               jnp.asarray(g))
    fit_t, fit_j = fit_t.numpy(), np.asarray(fit_j)
    np.testing.assert_array_equal(pe_t.numpy(), np.asarray(pe_j))
    np.testing.assert_array_equal(kt_t.numpy(), np.asarray(kt_j))
    np.testing.assert_array_equal(np.isinf(fit_t), np.isinf(fit_j))
    assert np.isfinite(fit_t).any() and np.isinf(fit_t).any()
    np.testing.assert_allclose(fit_t, fit_j, rtol=1e-5)


INF = float("inf")


@pytest.mark.parametrize("cur,cand,best,temp", [
    (5e6, 4e6, 4.5e6, 10.0),        # better: always taken
    (5e6, 5.02e6, 5e6, 10.0),       # a little worse: Metropolis draw
    (5e6, 5.02e6, 5e6, 1.0),
    (5e6, 9e6, 3e6, 0.01),          # much worse at low temperature
    (5e6, INF, 5e6, 10.0),          # infeasible candidate
    (INF, INF, INF, 10.0),          # both infeasible: explore
    (INF, 7e6, INF, 10.0),          # first feasible point
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sa_accept_replays_reference(cur, cand, best, temp, seed):
    """Both accepts on the same state, candidate, fitness and uniform draw
    (the draw is JAX's, read from the reference's accept key)."""
    kw = dict(platform="cloud")
    env_t, env_j = _envs("ncf", **kw)
    cfg = jbase.SAConfig(seed=seed)
    jeng = jbase.make_sa_engine(env_j, jenv.EnvConfig(**kw), cfg)
    teng = tbase.make_sa_engine(env_t, tenv.EnvConfig(**kw),
                                tbase.SAConfig(seed=seed))
    genome, key = jeng.init_genome(seed)
    best_genome = jnp.flip(genome, 0)
    f32 = lambda v: jnp.float32(v)
    jstate = jbase.SAState(genome, f32(cur), f32(best), best_genome,
                           f32(temp), key, jnp.zeros((), jnp.int32))
    jcand, k4, key2 = jeng.propose(jstate)
    u = jax.random.uniform(k4)
    jnext, jbest = jeng.accept(jstate, jcand, f32(cand), k4, key2)

    t = lambda a, dt=torch.float32: torch.as_tensor(np.array(a), dtype=dt)
    tstate = tbase.SAState(t(genome, torch.int64), t(cur), t(best),
                           t(best_genome, torch.int64), t(temp),
                           torch.Generator(), torch.zeros((),
                                                          dtype=torch.int64))
    tnext, tbest = teng.accept(tstate, t(jcand, torch.int64), t(cand), t(u))
    np.testing.assert_array_equal(tnext.genome.numpy(),
                                  np.asarray(jnext.genome))
    np.testing.assert_array_equal(tnext.best_genome.numpy(),
                                  np.asarray(jnext.best_genome))
    for a, b in ((tnext.cur_fit, jnext.cur_fit),
                 (tnext.best_fit, jnext.best_fit), (tbest, jbest),
                 (tnext.temp, jnext.temp)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    assert int(tnext.step) == int(jnext.step) == 1


def test_sa_propose_moves_one_gene_by_one_step():
    env_t, _ = _envs("mobilenet_v2", **KW)
    eng = tbase.make_sa_engine(env_t, tenv.EnvConfig(**KW),
                               tbase.SAConfig(step=2))
    genome, gen = eng.init_genome(4)
    state = tbase.SAState(genome, torch.tensor(1.0), torch.tensor(1.0),
                          genome, torch.tensor(10.0), gen,
                          torch.zeros((), dtype=torch.int64))
    for _ in range(50):
        cand, u = eng.propose(state)
        diff = (cand - state.genome).abs()
        assert int((diff != 0).sum()) <= 1 and int(diff.max()) <= 2
        assert int(cand.min()) >= 0 and int(cand.max()) <= 11
        assert 0.0 <= float(u) < 1.0
        state = state._replace(genome=cand)


@pytest.mark.parametrize("method", ["random", "grid", "bo", "sa"])
def test_eval_fn_path_byte_identical_to_built_in_evaluation(method):
    """The host-side eval_fn path draws what the built-in path draws: fed
    the built-in evaluation through the hook, a run gives the same bytes."""
    wl = tworkloads.get_workload("ncf")
    ecfg = tenv.EnvConfig(**KW)
    env = tenv.make_env(wl, ecfg, device="cpu")

    def genome_fn(genomes):
        return tuple(t.numpy() for t in tbase._decode_and_eval(
            env, ecfg, torch.from_numpy(np.asarray(genomes))))

    def raw_fn(pe, kt, df):
        perf, _, feas = tenv.genome_cost(env, ecfg, torch.from_numpy(pe),
                                         torch.from_numpy(kt), float(df))
        return torch.where(feas, perf, torch.inf).numpy()

    run = {"random": lambda fn: tbase.random_search(
               wl, ecfg, eps=300, seed=1, batch=64, eval_fn=fn, device="cpu"),
           "grid": lambda fn: tbase.grid_search(
               wl, ecfg, eps=300, batch=64, eval_fn=fn, device="cpu"),
           "bo": lambda fn: tbase.bayes_opt(
               wl, ecfg, eps=120, seed=1, eval_fn=fn, device="cpu"),
           "sa": lambda fn: tbase.simulated_annealing(
               wl, ecfg, eps=150, eval_fn=fn, device="cpu")}[method]
    want = run(None)
    got = run(raw_fn if method == "sa" else genome_fn)
    _same_result(got, want)


# ---------------------------------------------------------------------------
# Conformance over the port's registry (tests/test_optimizer_conformance.py).
# ---------------------------------------------------------------------------
ECFG_KW = dict(platform="cloud")
CASES = {
    "random": (150, {}),
    "grid": (150, {}),
    "bo": (150, {"init_random": 32, "batch": 16}),
    "sa": (150, {}),
    "ga": (120, {"population": 30}),
    "nsga2": (120, {"population": 30}),
    "reinforce": (30, {}),
    "two_stage": (30, {"ga": {"generations": 40}}),
    "a2c": (30, {"episodes_per_epoch": 3}),
    "ppo2": (30, {"episodes_per_epoch": 3, "ppo_updates": 1}),
    "relaxed": (30, {"steps_per_eval": 4, "restarts": 2}),
    "fanout": (100, {"inner": "random", "n_shards": 2, "backend": "serial"}),
    "dist_reinforce": (20, {}),
}
CHUNKED = ("reinforce", "two_stage", "ga", "nsga2", "sa", "a2c", "ppo2",
           "relaxed")


def _req(method, **kw):
    eps, options = CASES[method]
    return tapi.SearchRequest(workload="ncf", env=tapi.EnvConfig(**ECFG_KW),
                              eps=eps, seed=7, method=method,
                              options=dict(options), device="cpu", **kw)


def test_every_registered_method_has_a_conformance_case():
    assert set(CASES) == set(tapi.list_optimizers())
    assert tapi.get_optimizer("bayes").name == "bo"


@pytest.mark.parametrize("method", sorted(CASES))
def test_outcome_contract_and_rescoring(method):
    """Schema, monotone best-so-far ending at best_value, and the reported
    best re-scored by the JAX package: the same objective (rtol 1e-5) and
    feasible under its budget x (1 + 1e-6) (the two budgets are f32 sums
    in different orders)."""
    eps = CASES[method][0]
    out = tapi.run_search(_req(method))
    assert out.method == method and out.eps == eps and out.seed == 7
    assert out.history.shape == (eps,)
    finite = out.history[np.isfinite(out.history)]
    assert np.all(np.diff(finite) <= 1e-9)
    assert out.history[-1] == out.best_value
    N = out.pe.shape[0]
    assert out.pe.shape == out.kt.shape == out.df.shape == (N,)
    assert 1 <= out.samples_to_convergence <= eps
    assert out.feasible == bool(np.isfinite(out.best_value))
    if not out.feasible:
        return
    env_j = jenv.make_env(jworkloads.get_workload("ncf"),
                          jenv.EnvConfig(**ECFG_KW))
    perf, cons, _ = jenv.genome_cost(
        env_j, jenv.EnvConfig(**ECFG_KW), jnp.asarray(out.pe, jnp.float32),
        jnp.asarray(out.kt, jnp.float32), jnp.asarray(out.df))
    np.testing.assert_allclose(float(perf), out.best_value, rtol=1e-5)
    assert float(cons) <= float(env_j.budget) * (1 + 1e-6)


@pytest.mark.parametrize("method", sorted(CASES))
def test_fixed_seed_is_deterministic(method):
    a = tapi.run_search(_req(method))
    b = tapi.run_search(_req(method))
    assert a.best_value == b.best_value
    assert a.history.tobytes() == b.history.tobytes()
    assert a.pe.tobytes() == b.pe.tobytes()
    assert a.kt.tobytes() == b.kt.tobytes()


@pytest.mark.parametrize("method", sorted(CASES))
def test_trial_stream_covers_the_budget(method):
    eps = CASES[method][0]
    trials = []
    out = tapi.run_search(_req(method, on_progress=trials.append,
                               progress_every=max(eps // 3, 1)))
    assert trials
    by_shard = {}          # fanout tags its shards' sub-streams
    for t in trials:
        assert 1 <= t.step <= eps
        by_shard.setdefault(t.shard, []).append(t.step)
    for steps in by_shard.values():
        assert steps == sorted(steps) and steps[-1] == eps
    assert min(t.best_value for t in trials) == out.best_value


@pytest.mark.parametrize("method", CHUNKED)
def test_chunked_engines_stream_before_completion(method):
    eps = CASES[method][0]
    trials = []
    tapi.run_search(_req(method, on_progress=trials.append,
                         progress_every=max(eps // 3, 1)))
    assert len(trials) >= 2 and trials[0].step < eps
