"""The port's NSGA-II against the JAX package's, on the CPU.

  * The numpy Pareto helpers agree with the reference's on seeded random
    clouds with duplicates and ties: the same masks and fronts exactly,
    hypervolume to 1e-12 relative.
  * Selection on identical costs: the same (2P, 4) costs -- +inf
    sentinels, ties, mixed violations -- give bit-identical violations,
    dominance, front ranks, crowding distances (inf in the same places),
    survivor indices and archive updates from both packages.
  * A generation by replay: JAX threefry and torch generators draw
    different numbers, so the reference's initial population, its
    fitness and every draw of its ``evolve`` (tournament pairs, crossover
    and mutation uniforms, replacement levels and, under MIX, the
    ``fold_in`` dataflow genes) are fed into the port's ``evolve`` through
    ``nsga2._draws``.  After a few generations on ncf, plain and mix,
    parents, parent costs, archive, best value and best genome must be
    bit-equal.  The port's own fitness of the same genomes agrees with
    the reference's within rtol 1e-5 (its float32 sums run in another
    order).
  * Whole runs, by the properties tests/test_nsga2.py holds the reference
    to: chunked == one-shot and resumed == uninterrupted byte for byte,
    an injected eval_fn == the adapter's default, the in-graph fitness
    (table kernel path) == the flat per-row path bit for bit, the
    frontier non-dominated, feasible and re-scored by the reference's
    ``genome_costs_multi`` (rtol 1e-5, budget x (1 + 1e-6): the two
    packages sum float32 layers in different orders), ``best_value`` the
    frontier's least latency, the multi-DNN mix co-design, the aliases.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as jenv
from repro.core import nsga2 as jnsga2
from repro.costmodel import workloads as jworkloads
from repro_torch import api as tapi
from repro_torch.core import env as tenv
from repro_torch.core import nsga2 as tnsga2
from repro_torch.costmodel import workloads as tworkloads
from repro_torch.serving import batcher as tbatcher
from torch_threads import one_torch_thread  # noqa: F401,E402

ECFG_KW = dict(platform="cloud")
CFG = tnsga2.NSGA2Config(population=14, generations=9, seed=5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(rng, m, k=2):
    """Random objective cloud with deliberate duplicates and ties."""
    pts = rng.uniform(0.1, 10.0, size=(m, k))
    if m >= 4:
        pts[m // 2] = pts[0]
        pts[m // 4, 0] = pts[0, 0]
    return pts


# ---------------------------------------------------------------------------
# Pareto helpers.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_pareto_helpers_match_reference(seed):
    rng = np.random.default_rng(seed)
    for m in (1, 2, 5, 17, 40):
        pts = _cloud(rng, m)
        np.testing.assert_array_equal(tnsga2.non_dominated_mask(pts),
                                      jnsga2.non_dominated_mask(pts))
        ref = pts.max(axis=0) * 1.1
        got, want = tnsga2.hypervolume_2d(pts, ref), jnsga2.hypervolume_2d(
            pts, ref)
        assert abs(got - want) <= 1e-12 * abs(want)
        front_t, front_j = [], []
        for p in pts:
            front_t = tnsga2.pareto_insert(front_t, p)
            front_j = jnsga2.pareto_insert(front_j, p)
        np.testing.assert_array_equal(np.asarray(front_t),
                                      np.asarray(front_j))
        for a, b in zip(pts[:-1], pts[1:]):
            assert (tnsga2.pareto_dominates(a, b)
                    == jnsga2.pareto_dominates(a, b))
    assert tnsga2.non_dominated_mask(np.empty((0, 2))).shape == (0,)
    assert tnsga2.hypervolume_2d(np.empty((0, 2)), [1.0, 1.0]) == 0.0


# ---------------------------------------------------------------------------
# Selection on identical costs.
# ---------------------------------------------------------------------------
def _selection_costs(seed, M=28, budget=50.0):
    """(M, 4) float32 costs: a block of +inf sentinels, exact duplicates,
    ties in one objective, feasible points and several violations (some
    equal)."""
    rng = np.random.default_rng(seed)
    c = np.empty((M, 4), np.float32)
    c[:, :2] = rng.integers(1, 9, (M, 2)) * np.float32(1.5)
    c[:, 2] = rng.choice([10.0, 40.0, 50.0, 60.0, 75.0, 75.0, 90.0], M)
    c[:, 3] = rng.uniform(1.0, 100.0, M)
    c[: M // 4] = np.inf                       # first-survival sentinels
    c[M // 2] = c[M // 2 + 1]                  # an exact duplicate
    return c, np.float32(budget)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cons_col", [2, 3])
def test_selection_bit_identical_on_identical_costs(seed, cons_col):
    c, budget = _selection_costs(seed)
    jc, tc = jnp.asarray(c), _t(c)
    jb, tb = jnp.float32(budget), torch.tensor(budget)
    jv = jnsga2._violation(jc, cons_col, jb)
    tv = tnsga2._violation(tc, cons_col, tb)
    assert tv.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jd = jnsga2._constrained_dominance(jc, jv)
    td = tnsga2._constrained_dominance(tc, tv)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jr = jnsga2._front_ranks(jd)
    for every in (1, 3, 8, 64):
        tr = tnsga2._front_ranks(td, check_every=every)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert int(tr.max()) > 3                   # several fronts
    jcr = jnsga2._crowding(jc[:, :2], jr)
    tcr = tnsga2._crowding(tc[:, :2], tr)
    np.testing.assert_array_equal(np.isinf(tcr.numpy()),
                                  np.isinf(np.asarray(jcr)))
    assert tcr.numpy().tobytes() == np.asarray(jcr).tobytes()
    for n in (1, 7, 14, 28):
        np.testing.assert_array_equal(
            tnsga2._select_best(tr, tcr, n).numpy(),
            np.asarray(jnsga2._select_best(jr, jcr, n)))
    # Tournaments over all M candidates (ties in rank and in crowding,
    # +inf crowding among them), with the reference's candidate pairs.
    key = jax.random.PRNGKey(seed)
    ka, kb = jax.random.split(key)
    i, j = (jax.random.randint(k, (64,), 0, len(c)) for k in (ka, kb))
    np.testing.assert_array_equal(
        tnsga2._tournament(_t(i).long(), _t(j).long(), tr, tcr).numpy(),
        np.asarray(jnsga2._tournament(key, jr, jcr, 64, len(c))))


def _jax_engine(name="ncf", mix=False, **cfg_kw):
    ecfg_kw = dict(ECFG_KW, mix=mix)
    cfg_kw = dict(dict(population=CFG.population, seed=CFG.seed), **cfg_kw)
    env_j = jenv.make_env(jworkloads.get_workload(name),
                          jenv.EnvConfig(**ecfg_kw))
    env_t = tenv.make_env(tworkloads.get_workload(name),
                          tenv.EnvConfig(**ecfg_kw), device="cpu")
    jeng = jnsga2.make_nsga2_engine(env_j, jenv.EnvConfig(**ecfg_kw),
                                    jnsga2.NSGA2Config(**cfg_kw))
    teng = tnsga2.make_nsga2_engine(env_t, tenv.EnvConfig(**ecfg_kw),
                                    tnsga2.NSGA2Config(**cfg_kw))
    return env_j, env_t, jeng, teng


@pytest.mark.parametrize("seed", range(3))
def test_archive_update_bit_identical(seed):
    """The reference's archive update (inside its ``evolve``) against the
    port's ``_update_archive`` on the same archive, candidates and costs:
    empty slots, duplicates of archived points, infeasible and dominated
    candidates."""
    env_j, env_t, jeng, _ = _jax_engine(archive=10)
    rng = np.random.default_rng(seed)
    st = jeng.init_carry(seed)
    P, N, A = CFG.population, env_t.num_layers, 10
    budget = np.float32(env_j.budget)
    arch_c = np.full((A, 4), np.inf, np.float32)
    live = rng.uniform(1e5, 1e6, (6, 4)).astype(np.float32)
    live[:, 2] = budget * np.float32(0.5)
    arch_c[:6] = live
    arch_g = np.where(np.isfinite(arch_c[:, :1, None]),
                      rng.integers(0, 12, (A, N, 2)), 0).astype(np.int32)
    fit = rng.uniform(1e5, 1e6, (P, 4)).astype(np.float32)
    fit[:, 2] = np.where(rng.random(P) < 0.7, budget * np.float32(0.9),
                         budget * np.float32(1.5))
    fit[0] = live[1]                           # a duplicate of the archive
    fit[1, 0] = fit[2, 0]                      # a tie in one objective
    st = st._replace(arch_genomes=jnp.asarray(arch_g),
                     arch_costs=jnp.asarray(arch_c),
                     parent_costs=jnp.asarray(fit[::-1].copy()))
    out, _ = jax.jit(jeng.evolve)(st, jnp.asarray(fit))
    got_g, got_c = tnsga2._update_archive(
        _t(arch_g).long(), _t(arch_c), _t(np.asarray(st.pop)).long(),
        _t(fit), 2, torch.tensor(budget))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(out.arch_genomes))
    assert got_c.numpy().tobytes() == np.asarray(out.arch_costs).tobytes()
    assert np.isfinite(got_c.numpy()[:, 0]).sum() >= 2


# ---------------------------------------------------------------------------
# A generation by replay.
# ---------------------------------------------------------------------------
def _jax_draws(key, P, N, genes, L, mix):
    """The draws the reference's ``evolve`` makes from ``key``, in the
    port's :class:`~repro_torch.core.nsga2.Draws` layout."""
    _, k1, k2, k3, k4, k5 = jax.random.split(key, 6)

    def pairs(k):
        ka, kb = jax.random.split(k)
        return np.stack([np.asarray(jax.random.randint(ka, (P,), 0, P)),
                         np.asarray(jax.random.randint(kb, (P,), 0, P))])

    dataflows = (np.asarray(jax.random.randint(jax.random.fold_in(k5, 1),
                                               (P, N), 0, 3))
                 if mix else None)
    return tnsga2.Draws(
        tour_a=_t(pairs(k1)).long(), tour_b=_t(pairs(k2)).long(),
        cross=_t(np.asarray(jax.random.uniform(k3, (P, N, genes)))),
        mutate=_t(np.asarray(jax.random.uniform(k4, (P, N, genes)))),
        levels=_t(np.asarray(jax.random.randint(k5, (P, N, genes), 0,
                                                L))).long(),
        dataflows=None if dataflows is None else _t(dataflows).long())


def _assert_states_equal(ts, js):
    for f in ("pop", "parents", "best_genome", "arch_genomes"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for f in ("parent_costs", "arch_costs", "best_val"):
        assert (getattr(ts, f).numpy().tobytes()
                == np.asarray(getattr(js, f)).tobytes()), f
    assert int(ts.generation) == int(js.generation)


@pytest.mark.parametrize("mix", [False, True])
def test_generations_replayed_bit_identical(mix, monkeypatch):
    env_j, env_t, jeng, teng = _jax_engine(mix=mix)
    P, N, L = CFG.population, env_t.num_layers, 12
    genes = 3 if mix else 2
    js = jeng.init_carry(CFG.seed)
    ts = teng.init_carry(CFG.seed)._replace(pop=_t(np.asarray(js.pop)).long())
    jevolve = jax.jit(jeng.evolve)
    pending = []
    monkeypatch.setattr(tnsga2, "_draws", lambda *a: pending.pop())
    for g in range(6):
        jfit = np.asarray(jeng.fitness(js.pop))
        tfit = teng.fitness(ts.pop).numpy()
        np.testing.assert_array_equal(np.isinf(tfit), np.isinf(jfit))
        np.testing.assert_allclose(tfit, jfit, rtol=1e-5)
        pending.append(_jax_draws(js.key, P, N, genes, L, mix))
        js, jbest = jevolve(js, jnp.asarray(jfit))
        ts, tbest = teng.evolve(ts, _t(jfit))
        assert not pending
        _assert_states_equal(ts, js)
        assert tbest.numpy().tobytes() == np.asarray(jbest).tobytes()
    assert np.isfinite(float(ts.best_val))
    assert np.isfinite(ts.arch_costs.numpy()[:, 0]).sum() >= 2
    if mix:
        assert len(np.unique(ts.pop.numpy()[..., 2])) == 3


# ---------------------------------------------------------------------------
# Whole runs, by property.
# ---------------------------------------------------------------------------
def _env(name="ncf", **kw):
    kw = dict(ECFG_KW, **kw)
    return (tenv.make_env(tworkloads.get_workload(name), tenv.EnvConfig(**kw),
                          device="cpu"), tenv.EnvConfig(**kw))


def _bytes(state):
    return tuple(v.get_state().numpy().tobytes()
                 if isinstance(v, torch.Generator)
                 else v.numpy().tobytes() for v in state)


def test_chunked_and_resumed_runs_equal_one_shot():
    env, ecfg = _env()
    s1, h1 = tnsga2.run_nsga2_search(None, ecfg, CFG, env=env)
    for chunk in (2, 4):
        s2, h2 = tnsga2.run_nsga2_search(None, ecfg, CFG, env=env,
                                         chunk=chunk)
        assert h1.tobytes() == h2.tobytes()
        assert _bytes(s1) == _bytes(s2)
    first = dataclasses.replace(CFG, generations=4)
    rest = dataclasses.replace(CFG, generations=5)
    sa, ha = tnsga2.run_nsga2_search(None, ecfg, first, env=env)
    sb, hb = tnsga2.run_nsga2_search(None, ecfg, rest, state=sa, env=env)
    assert np.concatenate([ha, hb]).tobytes() == h1.tobytes()
    assert _bytes(sb) == _bytes(s1)
    assert int(sb.generation) == CFG.generations


@pytest.mark.parametrize("kw", [dict(platform="cloud"),
                                dict(platform="iot", mix=True,
                                     constraint="power", scenario="LS",
                                     objective="energy")])
def test_in_graph_fitness_equals_flat_path_bitwise(kw):
    """The engine's fitness (one table-kernel call at (P, N)) against the
    adapter's default (the per-row kernel on packed rows and the batcher's
    aggregation), on the populations of a run, and whole runs by both."""
    env, ecfg = _env("mobilenet_v2", **kw)
    cfg = dataclasses.replace(CFG, generations=4)
    eval_fn = tbatcher.make_local_costs_eval(env, ecfg)
    engine = tnsga2.make_nsga2_engine(env, ecfg, cfg)
    state = engine.init_carry(cfg.seed)
    for _ in range(cfg.generations):
        in_graph = engine.fitness(state.pop)
        flat = eval_fn(*(v.numpy() if torch.is_tensor(v) else np.float32(v)
                         for v in engine.decode(state.pop)))
        assert flat.shape == (cfg.population, 4) and flat.dtype == np.float32
        assert in_graph.numpy().tobytes() == flat.tobytes()
        state, _ = engine.evolve(state, in_graph)
    s1, h1 = tnsga2.run_nsga2_search(None, ecfg, cfg, env=env)
    s2, h2 = tnsga2.run_nsga2_search(None, ecfg, cfg, env=env,
                                     eval_fn=eval_fn)
    assert h1.tobytes() == h2.tobytes() and _bytes(s1) == _bytes(s2)


def test_injected_eval_fn_matches_adapter():
    env, ecfg = _env()
    eval_fn = tbatcher.make_local_costs_eval(env, ecfg)
    s1, h1 = tnsga2.run_nsga2_search(None, ecfg, CFG, env=env,
                                     eval_fn=eval_fn)
    s2, h2 = tnsga2.run_nsga2_search(None, ecfg, CFG, env=env, chunk=3,
                                     eval_fn=eval_fn)
    assert h1.tobytes() == h2.tobytes() and _bytes(s1) == _bytes(s2)
    out = tapi.run_search(tapi.SearchRequest(
        workload="ncf", env=ecfg, eps=CFG.population * CFG.generations,
        seed=CFG.seed, method="nsga2", device="cpu",
        options={"population": CFG.population,
                 "generations": CFG.generations}))
    assert out.best_value == float(s1.best_val)
    assert np.float32(out.history[-1]) == s1.best_val.numpy()
    np.testing.assert_array_equal(out.frontier["lat"],
                                  tnsga2.frontier_points(s1)[:, 0])


def _check_frontier(out, wl, ecfg_kw):
    """Non-dominated, sorted, feasible, and re-scored by the reference."""
    f = out.frontier
    F = len(f["lat"])
    assert F >= 1 and out.extras["frontier_size"] == F
    obj = np.stack([f["lat"], f["en"]], axis=-1)
    assert jnsga2.non_dominated_mask(obj).all()
    assert np.all(np.diff(f["lat"]) >= 0)
    ecfg = jenv.EnvConfig(**ecfg_kw)
    env = jenv.make_env(wl, ecfg)
    for i in range(F):
        tl, te, ta, tp, _ = jenv.genome_costs_multi(
            env, ecfg, jnp.asarray(f["pe"][i], jnp.float32),
            jnp.asarray(f["kt"][i], jnp.float32), np.asarray(f["df"][i]))
        np.testing.assert_allclose(
            [float(tl), float(te), float(ta), float(tp)],
            [f["lat"][i], f["en"][i], f["area"][i], f["pw"][i]], rtol=1e-5)
        assert float(ta) <= float(env.budget) * (1 + 1e-6)
    trace = out.extras["frontier_trace"]
    assert trace and np.array_equal(trace[-1][:, 0], f["lat"])
    return F


def test_frontier_is_nondominated_feasible_and_rescores():
    trials = []
    out = tapi.run_search(tapi.SearchRequest(
        workload="ncf", env=tapi.EnvConfig(**ECFG_KW), eps=150, seed=1,
        method="nsga2", options={"population": 15}, device="cpu",
        on_progress=trials.append, progress_every=45))
    assert len(out.history) == 150 and out.feasible
    assert np.all(out.history[1:] <= out.history[:-1])
    _check_frontier(out, jworkloads.get_workload("ncf"), ECFG_KW)
    assert out.best_value == float(np.min(out.frontier["lat"]))
    assert len(out.extras["frontier_trace"]) == len(trials) == 4
    assert "frontier: " in out.summary()


def test_mix_codesign_over_multi_dnn():
    names = ["qwen1p5_0p5b", "whisper_small", "mamba2_130m"]
    wl = tworkloads.multi_dnn(names, tokens=32)
    assert len({l.name.split(".")[0] for l in wl}) == 3
    ecfg_kw = dict(platform="cloud", mix=True)
    out = tapi.run_search(tapi.SearchRequest(
        workload=wl, env=tapi.EnvConfig(**ecfg_kw), eps=120, seed=0,
        method="nsga2", options={"population": 12}, device="cpu"))
    assert out.feasible and out.df.shape == (len(wl),)
    assert set(np.unique(out.df)) <= {0, 1, 2}
    _check_frontier(out, jworkloads.multi_dnn(names, tokens=32), ecfg_kw)


@pytest.mark.parametrize("alias", ["nsga2", "pareto", "moo"])
def test_aliases_resolve_to_nsga2(alias):
    opt = tapi.get_optimizer(alias)
    assert type(opt).__name__ == "NSGA2Optimizer" and opt.name == "nsga2"
