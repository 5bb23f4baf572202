"""The plain references against the program on the CPU, at small sizes:
the frozen cost model and budget against ``repro_torch``'s, and the
REINFORCE replay against the program's first epochs."""
import json

import numpy as np
import pytest
import torch

from perfbench import check
from perfbench.reference import costmodel as ref_cost
from perfbench.reference import policy as ref_policy
from perfbench.tests.tiny import REPO

CONFIGS = {n: json.loads((REPO / "perfbench" / "configs" / f"{n}.json")
                         .read_text())
           for n in ("mobilenet_v2.iot", "resnet50.cloud")}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("df", [0, 1, 2])
def test_cost_model_matches_the_programs(name, df):
    from repro_torch.costmodel import maestro

    layers = torch.as_tensor(np.asarray(CONFIGS[name]["layers"]),
                             dtype=torch.float32)
    rng = np.random.default_rng(df)
    pe = torch.as_tensor(rng.integers(1, 161, (64, len(layers))),
                         dtype=torch.float32)
    kt = torch.as_tensor(rng.integers(1, 17, (64, len(layers))),
                         dtype=torch.float32)
    mine = ref_cost.layer_costs(layers, pe, kt, float(df))
    theirs = maestro.evaluate(layers, pe, kt, float(df))
    for a, b in zip(mine, (theirs.latency, theirs.energy, theirs.area,
                           theirs.power)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_budget_matches_the_programs(name):
    from repro_torch.core import env as env_lib

    cfg = CONFIGS[name]
    layers = torch.as_tensor(np.asarray(cfg["layers"]), dtype=torch.float32)
    mine = np.float32(ref_cost.budget(layers, cfg["env"],
                                      cfg["budget"]["platform_fraction"]))
    env = env_lib.make_env(np.asarray(cfg["layers"]),
                           env_lib.EnvConfig(**cfg["env"]), "cpu")
    assert float(mine) == float(env.budget)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [3, 2 ** 40 + 7])
def test_replay_follows_the_programs_first_epochs(name, seed):
    from repro_torch import api

    cfg = CONFIGS[name]
    out = api.run_search(api.SearchRequest(
        workload=np.asarray(cfg["layers"], np.int32),
        env=api.EnvConfig(**cfg["env"]), eps=4, seed=seed,
        method="reinforce", options={"policy": cfg["policy"]},
        device="cpu"))
    replayed = ref_policy.replay(cfg, seed, epochs=3)
    gap, n = check.policy_gap(out.extras["history"], replayed)
    assert n == 3
    assert gap <= check.LIMITS["policy_gap"]


def test_rescore_reads_a_returned_assignment():
    cfg = CONFIGS["resnet50.cloud"]
    layers = torch.as_tensor(np.asarray(cfg["layers"]), dtype=torch.float32)
    budget = ref_cost.budget(layers.double(), cfg["env"],
                             cfg["budget"]["platform_fraction"],
                             torch.float64)
    N = len(cfg["layers"])

    class Out:
        feasible = True
        pe = np.full(N, 8.0)
        kt = np.full(N, 2.0)
        df = np.zeros(N)

    perf, cons = ref_cost.whole_model(layers, cfg["env"], Out.pe, Out.kt,
                                      Out.df)
    assert cons < budget
    Out.best_value = np.float32(perf)
    assert check.rescore_gap(Out, layers, cfg["env"], budget) < 1e-7
    Out.best_value = perf * 1.001
    assert check.rescore_gap(Out, layers, cfg["env"], budget) > 1e-4
    Out.best_value, Out.pe = perf, np.full(N, 160.0)    # over budget
    assert check.rescore_gap(Out, layers, cfg["env"], budget) > 1.0
