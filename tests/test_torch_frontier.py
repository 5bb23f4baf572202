"""The port's frontier side against the JAX package, on the CPU: Fig. 5's
heuristics, the scalarized frontier sweep, the architecture workloads the
frontier co-designs for, their configs, and the CLI's frontier record.

Deterministic parts are held to the reference on identical inputs:
  * ``heuristic_a`` / ``heuristic_b``: the same (PE, Buf) pair and hot
    layer exactly, the value within rtol 1e-6 (a float32 sum over the
    layers in another order: equal on ncf, one ulp apart on mobilenet_v2);
  * ``lower_arch`` for all ten architectures and ``multi_dnn``: equal
    ``layers_to_array`` and equal names; ``workload_names`` equal;
  * ``configs.get`` / ``get_smoke`` of the six configs beyond the dense
    family: equal dataclass fields.
The sweep's GA runs draw from torch generators, so its points are held to
the schema and re-scored by the reference's ``genome_costs_multi`` (rtol
1e-5, budget x (1 + 1e-6)).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import env as jenv
from repro.core import search as jsearch
from repro.costmodel import arch_workloads as jarch
from repro.costmodel import layers as jlayers
from repro.costmodel import workloads as jworkloads
from repro_torch import configs as tconfigs
from repro_torch.core import env as tenv
from repro_torch.core import search as tsearch
from repro_torch.costmodel import arch_workloads as tarch
from repro_torch.costmodel import layers as tlayers
from repro_torch.costmodel import workloads as tworkloads
from torch_threads import ONE_THREAD, one_torch_thread  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BEYOND_DENSE = ["llama3p2_vision_90b", "mamba2_130m", "phi3p5_moe_42b",
                "qwen3_moe_235b", "whisper_small", "zamba2_1p2b"]
MIX3 = ["qwen1p5_0p5b", "whisper_small", "mamba2_130m"]
HEURISTIC_ENVS = [dict(platform="iot"), dict(platform="cloud"),
                  dict(platform="cloud", scenario="LS", objective="energy",
                       constraint="power")]


def _same_layers(got, want):
    np.testing.assert_array_equal(tlayers.layers_to_array(got),
                                  jlayers.layers_to_array(want))
    assert [l.name for l in got] == [l.name for l in want]


@pytest.mark.parametrize("kw", HEURISTIC_ENVS)
@pytest.mark.parametrize("name", ["ncf", "mobilenet_v2"])
def test_heuristics_match_reference(name, kw):
    for fn in ("heuristic_a", "heuristic_b"):
        got = getattr(tsearch, fn)(name, tenv.EnvConfig(**kw), device="cpu")
        want = getattr(jsearch, fn)(name, jenv.EnvConfig(**kw))
        assert set(got) == set(want), fn
        np.testing.assert_array_equal(got["pe"], np.asarray(want["pe"]))
        np.testing.assert_array_equal(got["kt"], np.asarray(want["kt"]))
        assert got.get("hot_layer") == want.get("hot_layer")
        assert np.isinf(got["value"]) == np.isinf(want["value"])
        if np.isfinite(want["value"]):
            np.testing.assert_allclose(got["value"], want["value"],
                                       rtol=1e-6)
            if name == "ncf":
                assert got["value"] == want["value"]


def test_scalarized_sweep_points_rescore_on_the_reference():
    kw = dict(platform="cloud")
    out = tsearch.scalarized_frontier_sweep(
        "ncf", tenv.EnvConfig(**kw), eps=250, method="ga", seed=0,
        options={"population": 10}, device="cpu")
    assert out["weights"] == [0.0, 0.25, 0.5, 0.75, 1.0]
    assert len(out["outcomes"]) == 5
    assert all(o.method == "ga" and len(o.history) == 50
               for o in out["outcomes"])
    pts = out["points"]
    assert pts.shape == (sum(o.feasible for o in out["outcomes"]), 4)
    assert len(pts) >= 3
    ecfg = jenv.EnvConfig(**kw)
    env = jenv.make_env(jworkloads.get_workload("ncf"), ecfg)
    feasible = [o for o in out["outcomes"] if o.feasible]
    for o, p in zip(feasible, pts):
        tl, te, ta, tp, _ = jenv.genome_costs_multi(
            env, ecfg, jnp.asarray(o.pe, jnp.float32),
            jnp.asarray(o.kt, jnp.float32), np.asarray(o.df))
        np.testing.assert_allclose([float(tl), float(te), float(ta),
                                    float(tp)], p, rtol=1e-5)
        assert float(ta) <= float(env.budget) * (1 + 1e-6)
    # w = 1 is pure latency, w = 0 pure energy: the winners' blended
    # objective is the one they report.
    for o, w in zip(out["outcomes"], out["weights"]):
        if o.feasible:
            i = feasible.index(o)
            want = pts[i, 0] ** np.float32(w) * pts[i, 1] ** (
                np.float32(1.0) - np.float32(w))
            np.testing.assert_allclose(o.best_value, want, rtol=1e-5)


@pytest.mark.parametrize("tokens", [32, 1024])
@pytest.mark.parametrize("arch", list(jconfigs.ARCH_IDS))
def test_lower_arch_equals_reference(arch, tokens):
    _same_layers(tarch.lower_arch(arch, tokens=tokens),
                 jarch.lower_arch(arch, tokens=tokens))


def test_arch_names_and_aliases_lower_as_the_reference():
    assert tarch.arch_names() == jarch.arch_names()
    _same_layers(tworkloads.get_workload("qwen3-32b", tokens=512),
                 jworkloads.get_workload("qwen3-32b", tokens=512))
    _same_layers(tarch.lower_arch("whisper_small", tokens=64, ctx=128,
                                  include_unembed=False),
                 jarch.lower_arch("whisper_small", tokens=64, ctx=128,
                                  include_unembed=False))


@pytest.mark.parametrize("names", [None, MIX3, ["ncf", "qwen2p5_3b"]])
def test_multi_dnn_equals_reference(names):
    _same_layers(tworkloads.multi_dnn(names, tokens=32),
                 jworkloads.multi_dnn(names, tokens=32))
    if names is None:
        _same_layers(tworkloads.get_workload("multi_dnn"),
                     jworkloads.get_workload("multi_dnn"))


@pytest.mark.parametrize("arch", BEYOND_DENSE)
def test_configs_beyond_dense_are_the_references(arch):
    assert (dataclasses.asdict(tconfigs.get(arch))
            == dataclasses.asdict(jconfigs.get(arch)))
    assert (dataclasses.asdict(tconfigs.get_smoke(arch))
            == dataclasses.asdict(jconfigs.get_smoke(arch)))
    assert tconfigs.get(tconfigs.canonical(arch)).name == arch


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", **ONE_THREAD)
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)


def test_cli_arch_nsga2_writes_the_reference_frontier_record(tmp_path):
    args = ["--arch", "qwen3-32b", "--method", "nsga2", "--epochs", "96",
            "--ga-population", "16", "--archive", "32", "--tokens", "64"]
    recs = {}
    for module, extra in (("repro_torch.launch.search", ["--device", "cpu"]),
                          ("repro.launch.search", [])):
        out = tmp_path / f"{module}.json"
        proc = _run(module, *args, *extra, "--out", str(out))
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert proc.stdout.splitlines()[0].startswith(
            "target=qwen3-32b method=nsga2 layers=7 ")
        recs[module] = json.loads(out.read_text())
    got, want = recs["repro_torch.launch.search"], recs["repro.launch.search"]
    assert set(got) - {"device"} == set(want)
    assert list(got["frontier"]) == list(want["frontier"])
    assert got["frontier_size"] == len(got["frontier"]["lat"]) >= 1
    assert got["assignment"]["layers"] == want["assignment"]["layers"]
    assert got["best_value"] == min(got["frontier"]["lat"])
