"""The port's GA fitness, per-layer sweep, searches and CLI against the JAX
package, on the CPU.

Random engines cannot match the reference seed for seed (JAX threefry and
torch generators differ), so whole searches are held to the outcome
schema, and their reported best is re-scored by the reference's own
``genome_cost``: it must give ``best_value`` (rtol 1e-5) and be feasible
under the reference's budget x (1 + 1e-6) -- the two budgets are f32 sums
over the layers in different orders and may differ by an ulp.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as jenv
from repro.core import ga as jga
from repro.core import search as jsearch
from repro.costmodel import workloads as jworkloads
from repro_torch import api as tapi
from repro_torch.core import env as tenv
from repro_torch.core import ga as tga
from repro_torch.core import search as tsearch
from repro_torch.costmodel import workloads as tworkloads
from torch_threads import ONE_THREAD, one_torch_thread  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAST_LINE_KEYS = ["method", "best_value", "stage1_value",
                  "initial_valid_value", "samples_to_convergence",
                  "wall_seconds"]


def _envs(name, **kw):
    return (tenv.make_env(tworkloads.get_workload(name), tenv.EnvConfig(**kw),
                          device="cpu"),
            jenv.make_env(jworkloads.get_workload(name),
                          jenv.EnvConfig(**kw)))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("kw", [dict(platform="iot"),
                                dict(platform="cloud", scenario="LS",
                                     objective="energy", constraint="power")])
def test_ga_fitness_matches_reference(kw, use_kernel):
    env_t, env_j = _envs("mobilenet_v2", **kw)
    N = env_t.num_layers
    rng = np.random.default_rng(2)
    for P, hi_pe, hi_kt in ((20, 161, 17), (100, 40, 8)):
        pe = rng.integers(1, hi_pe, (P, N)).astype(np.float32)
        kt = rng.integers(1, hi_kt, (P, N)).astype(np.float32)
        df = rng.integers(0, 3, (N,)).astype(np.float32)
        got = tga._fitness(env_t, tenv.EnvConfig(**kw), torch.from_numpy(pe),
                           torch.from_numpy(kt), torch.from_numpy(df))
        want = np.asarray(jga._fitness(env_j, jenv.EnvConfig(**kw), pe, kt,
                                       jnp.asarray(df), use_kernel))
        np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_per_layer_optima_match_reference():
    ecfg = dict(platform="iot", scenario="LS")
    got = tsearch.per_layer_optima("mobilenet_v2", tenv.EnvConfig(**ecfg),
                                   device="cpu")
    want = jsearch.per_layer_optima("mobilenet_v2", jenv.EnvConfig(**ecfg))
    for k in ("latency", "energy", "area"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-2)
    for k in ("optima_latency", "optima_energy", "pe_table", "kt_table"):
        np.testing.assert_array_equal(got[k], want[k])


def _check_outcome(out, eps, ecfg_kw):
    assert len(out.history) == eps
    assert np.all(out.history[1:] <= out.history[:-1])
    assert out.history[-1] == out.best_value
    assert out.feasible and np.isfinite(out.best_value)
    env_j = jenv.make_env(jworkloads.get_workload("ncf"),
                          jenv.EnvConfig(**ecfg_kw))
    perf, cons, _ = jenv.genome_cost(
        env_j, jenv.EnvConfig(**ecfg_kw), jnp.asarray(out.pe, jnp.float32),
        jnp.asarray(out.kt, jnp.float32), jnp.asarray(out.df))
    np.testing.assert_allclose(float(perf), out.best_value, rtol=1e-5)
    assert float(cons) <= float(env_j.budget) * (1 + 1e-6)


@pytest.mark.parametrize("method,options", [
    ("two_stage", {"ga": {"generations": 60}}),
    ("ga", {"population": 20}),
    ("reinforce", {"episodes_per_epoch": 2}),
    ("a2c", {"episodes_per_epoch": 4}),
    ("ppo2", {"episodes_per_epoch": 4, "ppo_updates": 2}),
    ("relaxed", {"steps_per_eval": 4, "restarts": 2}),
])
def test_run_search_on_cpu_holds_schema_and_rescores(method, options):
    ecfg_kw = dict(platform="cloud")
    eps = 60
    trials = []
    req = tapi.SearchRequest(workload="ncf", env=tapi.EnvConfig(**ecfg_kw),
                             eps=eps, seed=1, method=method, options=options,
                             device="cpu", on_progress=trials.append,
                             progress_every=20)
    out = tapi.run_search(req)
    assert out.method == method and out.telemetry is None
    _check_outcome(out, eps, ecfg_kw)
    assert trials and all(t.step <= eps for t in trials)
    assert trials[-1].best_value >= out.best_value


# The reference's registry without what the port has not ported yet:
# nothing.
NOT_PORTED = set()


def test_registry_is_the_references_minus_the_unported():
    from repro import api as japi
    from repro.api import registry as jregistry

    want = tuple(m for m in japi.list_optimizers() if m not in NOT_PORTED)
    assert tapi.list_optimizers() == want
    for alias, name in jregistry._ALIASES.items():
        if name not in NOT_PORTED:
            assert tapi.get_optimizer(alias).name == name, alias


@pytest.mark.parametrize("alias,name", [("ppo", "ppo2"),
                                        ("oneshot", "relaxed"),
                                        ("gradient", "relaxed")])
def test_new_aliases_run_their_method(alias, name):
    out = tapi.run_search(tapi.SearchRequest(
        workload="ncf", env=tapi.EnvConfig(platform="cloud"), eps=8,
        method=alias, device="cpu",
        options={"steps_per_eval": 2, "restarts": 1, "ppo_updates": 1}))
    assert out.method == name and len(out.history) == 8


def test_two_stage_fine_tune_never_worse_than_stage1():
    out = tapi.run_search(tapi.SearchRequest(
        workload="ncf", env=tapi.EnvConfig(platform="iot"), eps=50,
        method="two_stage", options={"ga": {"generations": 80}},
        device="cpu"))
    assert out.best_value <= out.extras["stage1_value"]
    assert len(out.extras["ga_history"]) == 80


def test_ga_resumes_bit_identically_across_chunks():
    env_t, _ = _envs("ncf", platform="cloud")
    cfg = tga.GAConfig(population=16, generations=12, seed=3)
    ecfg = tenv.EnvConfig(platform="cloud")
    one, h1 = tga.run_ga_search(None, ecfg, cfg, env=env_t)
    many, h2 = tga.run_ga_search(None, ecfg, cfg, env=env_t, chunk=5)
    np.testing.assert_array_equal(h1, h2)
    np.testing.assert_array_equal(one.best_genome.numpy(),
                                  many.best_genome.numpy())


def test_request_on_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.run_search(tapi.SearchRequest(workload="ncf", eps=10))


def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", **ONE_THREAD)
    proc = subprocess.run([sys.executable, "-m", module, *args], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cli_prints_the_reference_last_line_keys():
    args = ("--workload", "ncf", "--epochs", "40", "--ga-generations", "50")
    got = _cli("repro_torch.launch.search", *args, "--device", "cpu")
    want = _cli("repro.launch.search", *args)
    assert list(got) == list(want) == LAST_LINE_KEYS
    assert got["method"] == "two_stage" and np.isfinite(got["best_value"])


def test_cli_rejects_arch_as_not_ported():
    """``--arch`` (rejected before the port had the lowering) now runs,
    and lowers the architecture at ``--tokens`` as the reference's
    launcher does: equal layer arrays and names, the same target."""
    from repro.costmodel import layers as jlayers
    from repro.launch import search as jlaunch
    from repro_torch.costmodel import layers as tlayers
    from repro_torch.launch import search as tlaunch

    flags = ["--arch", "qwen3-32b", "--tokens", "128", "--method", "ga"]
    got = tlaunch.build_request(
        _cli_args(tlaunch, flags + ["--device", "cpu"]))
    want = jlaunch.build_request(_cli_args(jlaunch, flags))
    np.testing.assert_array_equal(tlayers.layers_to_array(got.workload),
                                  jlayers.layers_to_array(want.workload))
    assert ([l.name for l in got.workload]
            == [l.name for l in want.workload])
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               **ONE_THREAD)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.search", *flags,
         "--device", "cpu", "--epochs", "60", "--ga-population", "10",
         "--platform", "cloud"], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("target=qwen3-32b method=ga layers=7 ")
    assert json.loads(proc.stdout.splitlines()[-1])["method"] == "ga"


def _cli_args(mod, argv):
    """The argparse namespace ``mod.main(argv)`` would build."""
    captured = {}
    orig = mod.build_request

    def spy(args):
        captured["args"] = args
        raise SystemExit(0)

    mod.build_request = spy
    try:
        with pytest.raises(SystemExit):
            mod.main(argv)
    finally:
        mod.build_request = orig
    return captured["args"]


def test_cli_text_names_every_registered_method(capsys):
    """The launcher's docstring and its --help name every method the
    registry has, and the blend help says what the reference says."""
    import re

    from repro_torch.launch import search as tlaunch

    with pytest.raises(SystemExit):
        tlaunch.main(["--help"])
    help_text = " ".join(capsys.readouterr().out.split())
    for method in tapi.list_optimizers():
        pattern = rf"\b{method}\b"
        assert re.search(pattern, tlaunch.__doc__), method
        assert re.search(pattern, help_text), method
    assert "(sampling methods only)" in help_text
    assert "ga only" not in help_text
    assert "1e-3 for a2c/ppo2" in help_text


def test_cli_maps_the_relaxed_flags_into_options():
    from repro.launch import search as jlaunch
    from repro_torch.launch import search as tlaunch

    flags = ["--workload", "ncf", "--method", "relaxed", "--epochs", "6",
             "--relaxed-steps", "3", "--relaxed-restarts", "2",
             "--tau-start", "0.5", "--tau-min", "0.1"]
    captured = {}

    def grab(mod, argv):
        orig = mod.build_request

        def spy(args):
            captured[mod.__name__] = orig(args)
            raise SystemExit(0)

        mod.build_request = spy
        try:
            with pytest.raises(SystemExit):
                mod.main(argv)
        finally:
            mod.build_request = orig

    grab(tlaunch, flags + ["--device", "cpu"])
    grab(jlaunch, flags)
    got = captured["repro_torch.launch.search"].options
    want = captured["repro.launch.search"].options
    for k in ("steps_per_eval", "restarts", "tau_start", "tau_min"):
        assert got[k] == want[k], k
    assert (got["steps_per_eval"], got["restarts"]) == (3, 2)
