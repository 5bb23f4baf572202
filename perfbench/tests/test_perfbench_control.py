"""The control: the reference in the precision just below the
configurations' float32 with TF32 off, put in the program's place, must
come out as not correct; and a policy that never learns must fail the
policy number.  On the CPU at the cells' own widths and layer tables
(three epochs of the policy; assignments re-scored); on the card
``perfbench/control.py`` reads the same numbers at the cells' full size
(PERF.md holds the readings the limits were set from)."""
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
SEEDS = (11, 12, 13)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_policy_that_never_learns_fails_the_policy_limit(name):
    """What a search whose optimizer step changes nothing reports is the
    replay at learning rate 0: epochs 2 and 3 draw other actions."""
    cfg = CONFIGS[name]
    gaps = []
    for seed in SEEDS:
        ref = ref_policy.replay(cfg, seed)
        still = ref_policy.replay(cfg, seed, lr=0.0)
        hist = {k: [r[k] for r in still]
                for k in ("loss", "mean_value", "best_value")}
        gaps.append(check.policy_gap(hist, ref)[0])
    assert min(gaps) > check.LIMITS["policy_gap"], gaps


def test_tf32_replay_departs_from_the_float32_one():
    """The control's policy: TF32 products move the first epoch's loss
    (it fails no limit alone; the control's bfloat16 cost model fails
    ``rescore_gap``)."""
    cfg = CONFIGS["mobilenet_v2.iot"]
    ref = ref_policy.replay(cfg, 11, epochs=1)
    ctl = ref_policy.replay(cfg, 11, epochs=1, mode="tf32")
    assert ctl[0]["loss"] != ref[0]["loss"]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -3.0 - 2 ** -9])
    y = ref_policy._tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                          -3.0 - 2 ** -9]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bfloat16_cost_model_fails_the_rescore_limit(name):
    cfg = CONFIGS[name]
    layers = torch.as_tensor(np.asarray(cfg["layers"]), dtype=torch.float32)
    budget = ref_cost.budget(layers.double(), cfg["env"],
                             cfg["budget"]["platform_fraction"],
                             torch.float64)
    N = len(cfg["layers"])
    rng = np.random.default_rng(0)
    gaps = []
    for _ in SEEDS:
        class Out:
            feasible = True
            pe = rng.integers(1, 9, N).astype(np.float64)
            kt = rng.integers(1, 4, N).astype(np.float64)
            df = np.zeros(N)
        gaps.append(check.rescore_gap(Out, layers, cfg["env"], budget,
                                      torch.bfloat16))
    assert min(gaps) > check.LIMITS["rescore_gap"], gaps


def test_the_judgement_sets_tf32_off_for_itself(monkeypatch):
    """The reference's products are float32 whatever the program left
    set, and the program's setting is back afterwards."""
    seen = []
    replay = ref_policy.replay

    def spy(*a, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return replay(*a, **kw)

    monkeypatch.setattr(ref_policy, "replay", spy)
    cfg = CONFIGS["resnet50.cloud"]
    mix = {"checks": ["policy_gap"]}

    class Request:
        seed, options = 11, {}

    class Outcome:
        extras = {}

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    check.judge([(Request, Outcome)], cfg, mix, torch.device("cpu"))
    assert seen == [(False, False)]
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == (True, True)
    monkeypatch.undo()
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before


def test_control_script_reads_the_program_and_a_planted_fault(tmp_path):
    from perfbench import control
    from perfbench.tests import tiny

    root = tiny.checkout(tmp_path)
    sound = control.readings(root, "tiny.two_stage", [21, 22], "cpu")
    frozen = control.readings(root, "tiny.two_stage", [21, 22], "cpu",
                              fault="ga_frozen")
    limit = check.LIMITS["ga_stall"]
    assert max(sound["program"]["ga_stall"]) <= limit
    assert frozen["program"]["ga_stall"] == [1.0, 1.0]
    assert min(sound["control"]["rescore_gap"]) > \
        check.LIMITS["rescore_gap"]
