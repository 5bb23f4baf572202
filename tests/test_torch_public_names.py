"""Small public names of the JAX package, each held to its counterpart in
the port on the same inputs, on the CPU: ``maestro.evaluate_point``,
``configs.all_configs``, ``env.layer_cost`` and ``action_tables``,
``ga.GAResult`` / ``baseline_ga`` / ``local_ga``, ``rl_baselines.
ACRollout``, ``obs.state.is_enabled`` and ``obs.trace.timed``.

The GA runs cannot match seed for seed (JAX threefry keys and torch
generators differ): they are held to the reference's schema and
evaluation count, and their best value to the hard model re-scoring
their best design.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401,E402

COST_FIELDS = ("latency", "energy", "area", "power", "l1_bytes", "l2_bytes",
               "macs", "util")


def _layers(name="mobilenet_v2"):
    from repro.costmodel import layers as jlayers
    from repro.costmodel import workloads as jworkloads

    return jlayers.layers_to_array(jworkloads.get_workload(name))


def test_evaluate_point_equals_reference():
    from repro.costmodel import maestro as jmaestro

    from repro_torch.costmodel import maestro

    layers = _layers()
    rng = np.random.default_rng(5)
    for t in rng.choice(layers.shape[0], 12, replace=False):
        pe = float(rng.integers(1, 161))
        kt = float(rng.integers(1, 17))
        for df in range(3):
            want = jmaestro.evaluate_point(layers[t], pe, kt, df)
            got = maestro.evaluate_point(torch.from_numpy(layers[t]), pe, kt,
                                         df)
            for f in COST_FIELDS:
                np.testing.assert_array_equal(
                    getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                    err_msg=f)


def test_all_configs_equal_reference():
    from repro import configs as jconfigs

    from repro_torch import configs

    got, want = configs.all_configs(), jconfigs.all_configs()
    assert [c.name for c in got] == [c.name for c in want]
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


@pytest.mark.parametrize("objective,constraint", [("latency", "area"),
                                                  ("energy", "power")])
def test_layer_cost_and_action_tables_equal_reference(objective, constraint):
    from repro.core import env as jenv

    from repro_torch.core import env

    kw = dict(objective=objective, constraint=constraint, platform="cloud")
    jcfg, cfg = jenv.EnvConfig(**kw), env.EnvConfig(**kw)
    layers = _layers("ncf")
    jarr = jenv.make_env(layers, jcfg)
    arr = env.make_env(layers, cfg, device="cpu")
    for want, got in zip(jenv.action_tables(jcfg), env.action_tables(cfg)):
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(9)
    for t in range(layers.shape[0]):
        pe, kt = float(rng.integers(1, 161)), float(rng.integers(1, 17))
        df = int(rng.integers(0, 3))
        want = jenv.layer_cost(jarr, jcfg, t, pe, kt, df)
        got = env.layer_cost(arr, cfg, t, pe, kt, df)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_layer_cost_rejects_blend_as_the_reference_does():
    from repro.core import env as jenv

    from repro_torch.core import env

    layers = _layers("ncf")
    kw = dict(objective="blend", platform="cloud")
    jcfg, cfg = jenv.EnvConfig(**kw), env.EnvConfig(**kw)
    with pytest.raises(ValueError, match="blend") as want:
        jenv.layer_cost(jenv.make_env(layers, jcfg), jcfg, 0, 16.0, 4.0, 0)
    with pytest.raises(ValueError, match="blend") as got:
        env.layer_cost(env.make_env(layers, cfg, device="cpu"), cfg, 0,
                       16.0, 4.0, 0)
    assert str(got.value) == str(want.value)


def _rescored(res, cfg, wl):
    from repro_torch.core import env

    arr = env.make_env(wl, cfg, device="cpu")
    perf, _, feas = env.genome_cost(arr, cfg, res.best_pe, res.best_kt,
                                    res.best_df)
    return float(perf), bool(feas)


def test_baseline_ga_and_local_ga_results():
    from repro.core import env as jenv
    from repro.core import ga as jga

    from repro_torch.core import env, ga

    assert ga.GAResult._fields == jga.GAResult._fields
    wl = _layers("ncf")
    kw = dict(platform="cloud")
    cfg = env.EnvConfig(**kw)
    gcfg = dict(population=20, generations=15, seed=1)
    want = jga.baseline_ga(wl, jenv.EnvConfig(**kw), jga.GAConfig(**gcfg))
    got = ga.baseline_ga(wl, cfg, ga.GAConfig(**gcfg), device="cpu")
    N = wl.shape[0]
    assert got.evals == want.evals == 20 * 15
    assert tuple(got.history.shape) == tuple(want.history.shape) == (15,)
    assert tuple(got.best_pe.shape) == tuple(got.best_kt.shape) == (N,)
    assert tuple(got.best_df.shape) == (N,)
    value, feas = _rescored(got, cfg, wl)
    assert feas and np.isfinite(float(got.best_value))
    np.testing.assert_allclose(value, float(got.best_value), rtol=1e-5)
    assert float(got.history[-1]) == float(got.best_value)
    lcfg = dict(population=10, generations=8, seed=2)
    want = jga.local_ga(wl, jenv.EnvConfig(**kw), np.asarray(want.best_pe),
                        np.asarray(want.best_kt), np.asarray(want.best_df),
                        jga.LocalGAConfig(**lcfg))
    loc = ga.local_ga(wl, cfg, got.best_pe, got.best_kt, got.best_df,
                      ga.LocalGAConfig(**lcfg), device="cpu")
    assert loc.evals == want.evals == 10 * 8
    assert tuple(loc.history.shape) == tuple(want.history.shape) == (8,)
    assert torch.equal(loc.best_df, got.best_df.to(torch.int64))
    assert loc.best_pe.dtype == torch.float32
    value, feas = _rescored(loc, cfg, wl)
    assert feas
    np.testing.assert_allclose(value, float(loc.best_value), rtol=1e-5)
    assert float(loc.best_value) <= float(got.best_value)


def test_ac_rollout_fields_and_episode_view():
    from repro.core import rl_baselines as jrl

    from repro_torch.core import env, policy, rl_baselines

    assert rl_baselines.ACRollout._fields == jrl.ACRollout._fields
    ecfg = env.EnvConfig(platform="cloud")
    pcfg = policy.PolicyConfig()
    arr = env.make_env(_layers("ncf"), ecfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = rl_baselines.init_ac_params(pcfg, gen, device="cpu")
    roll = rl_baselines.make_ac_rollout(ecfg, pcfg, arr)(
        params, torch.full((3,), float("inf")), gen, 3)
    one = rl_baselines.ACRollout.from_rollout(roll, 1)
    N = arr.num_layers
    assert one.obs.shape == (N, ecfg.obs_dim)
    assert one.actions.shape == (N, 3) and one.values.shape == (N,)
    for f in one._fields:
        assert torch.equal(getattr(one, f), getattr(roll, f)[1])


def test_is_enabled_follows_the_switch():
    from repro.obs import state as jstate

    from repro_torch.obs import state

    for on in (True, False):
        state.enabled = jstate.enabled = on
        assert state.is_enabled() is jstate.is_enabled() is on


def test_timed_records_the_block_as_the_reference_does():
    from repro.obs import trace as jtrace

    from repro_torch.obs import trace

    got, want = {}, {}
    for mod, out in ((trace, got), (jtrace, want)):
        with mod.timed(out, "block"):
            time.sleep(0.01)
        with pytest.raises(RuntimeError):
            with mod.timed(out, "failed"):
                raise RuntimeError("inside")
    assert set(got) == set(want) == {"block", "failed"}
    assert got["block"] >= 0.01 and want["block"] >= 0.01
