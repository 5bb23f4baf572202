"""Whether what the timed searches returned is correct.

Each number compared is a worst case over the searches a run judges (a
sum for a count; for ``ga_stall`` the least, see below), and has a limit
of its own (:data:`LIMITS`; PERF.md gives the readings each was set
from).  The traffic mix names the numbers that apply to it.

* ``rescore_gap`` (every search): the returned assignment re-scored by
  the plain cost model (:mod:`perfbench.reference.costmodel`), against a
  budget worked out again from the layer table: the larger of the relative
  gap between the returned objective and the re-scored one, and the share
  by which the re-scored constraint exceeds the budget.  A search that
  claims no feasible point reads 0 here (it is counted as failed).
* ``policy_gap`` (stage-1 searches that report their epochs): the first
  :data:`POLICY_EPOCHS` epochs replayed by the plain REINFORCE
  (:mod:`perfbench.reference.policy`) from the search's seed; the largest
  relative gap of the first epoch's loss (against the sum of its terms'
  magnitudes) and of each epoch's objective and best value so far.  The
  later epochs' losses are not compared: Adam's first steps scale every
  gradient element to about the learning rate, those that rounding
  alone sets too, so the reference's own loss moves by up to 6e-7 when
  its costs move by an ulp.  Epochs from the first that comes within
  rounding of a tie on are not compared.
* ``stage2_errors`` (two-stage searches whose stage 1 found a feasible
  point): the count of broken invariants of stage 2 (the local GA): its
  history holds the requested number of generations and never rises; it
  starts from stage 1's answer (at or below ``stage1_value``, within the
  re-score limit, or at +inf where rounding puts that answer just over
  the budget); the search returns the better of ``stage1_value`` and the
  history's last value.  A search whose stage 1 found nothing runs no GA.
* ``ga_stall`` (the same searches): the generation of the GA's first gain
  over its start, as a share of its generations (1 where it never gains),
  the least over the run's searches.  Stage 2 fine-tunes stage 1's answer
  by local mutation; a GA that never changes its population never gains.
  A sound GA gains on almost every seed, but not on all (where stage 1's
  answer is already the best of its neighbourhood), so one search
  alone cannot tell; the least over a run's searches can.

Every number is read with float32 products on both sides: the reference
sets TF32 off for itself, whatever the program left set.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from perfbench.reference import costmodel as ref_cost
from perfbench.reference import policy as ref_policy

LIMITS = {"rescore_gap": 2e-6, "policy_gap": 1e-6, "stage2_errors": 0,
          "ga_stall": 0.5}

POLICY_EPOCHS = 3


def _rel(a: float, b: float) -> float:
    if a == b:
        return 0.0
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def rescore_gap(outcome, layers, env, budget, control=None) -> float:
    """The re-score reading of one outcome (see the module docstring).
    With ``control`` (a dtype), the objective a program computing the cost
    model in that precision would return stands in for the outcome's."""
    if not outcome.feasible:
        return 0.0
    pe, kt, df = (np.asarray(a, np.float64) for a in
                  (outcome.pe, outcome.kt, outcome.df))
    if not (np.all(np.isfinite(pe)) and np.all(np.isfinite(kt))):
        return math.inf
    perf, cons = ref_cost.whole_model(layers, env, pe, kt, df)
    claimed = (float(outcome.best_value) if control is None else
               ref_cost.whole_model(layers, env, pe, kt, df, control)[0])
    excess = max(0.0, cons / budget - 1.0) if math.isfinite(budget) else 0.0
    return max(_rel(claimed, perf), excess)


def policy_gap(history: dict, replayed) -> tuple:
    """(gap, epochs compared) of a search's stage-1 ``history`` (arrays by
    metric) against the reference's replay of its first epochs."""
    gap, n = 0.0, 0
    for e, r in enumerate(replayed):
        if r["margin"] < ref_policy.TIE or r["budget_margin"] < ref_policy.TIE:
            break
        if e >= len(history.get("loss", [])):
            return math.inf, n
        gap = max(gap,
                  _rel(float(history["mean_value"][e]), r["mean_value"]),
                  _rel(float(history["best_value"][e]), r["best_value"]))
        if e == 0:
            loss = float(history["loss"][0])
            gap = max(gap, abs(loss - r["loss"]) / max(r["loss_scale"], 1e-30)
                      if math.isfinite(loss) else math.inf)
        n += 1
    return gap, n


def _stage2(outcome, request):
    """(stage-1 value, GA history, generations requested) of a two-stage
    outcome."""
    gens = int(request.options.get("ga", {}).get("generations", 2000))
    return (float(outcome.extras.get("stage1_value", math.nan)),
            np.asarray(outcome.extras.get("ga_history", []), np.float64),
            gens)


def stage2_errors(outcome, request) -> int:
    """Broken invariants of a two-stage outcome's stage 2."""
    stage1, hist, gens = _stage2(outcome, request)
    if math.isnan(stage1):
        return 1
    if not math.isfinite(stage1):
        return int(len(hist) != 0)
    if len(hist) != gens:
        return 1
    errors = int(not np.all(hist[1:] <= hist[:-1]))
    start = float(hist[0])
    errors += int(not (start <= stage1 * (1 + LIMITS["rescore_gap"])
                       or start == math.inf))
    errors += int(float(outcome.best_value) != min(stage1, float(hist[-1])))
    return errors


def ga_stall(outcome, request):
    """The generation of stage 2's first gain over its start, over its
    generations; None where stage 1 found nothing (no GA runs)."""
    stage1, hist, gens = _stage2(outcome, request)
    if not math.isfinite(stage1):
        return None
    gains = np.flatnonzero(hist < hist[0]) if len(hist) else []
    return float(gains[0]) / gens if len(gains) else 1.0


@contextlib.contextmanager
def _float32_products():
    """TF32 off for matmuls and convolutions, restored on exit."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def judge(runs, config: dict, traffic: dict, device,
          control: bool = False) -> dict:
    """The cell's numbers over ``runs``, a list of (request, outcome).

    ``control`` puts the reference one precision lower in the program's
    place: the policy numbers are then those of its replay with TF32
    products against the float32 one, and the re-score reads the
    objective in bfloat16 against the float32 one.
    """
    with _float32_products():
        return _judge(runs, config, traffic, device, control)


def _judge(runs, config, traffic, device, control):
    names = traffic["checks"]
    layers = torch.as_tensor(np.asarray(config["layers"], np.int64),
                             dtype=torch.float32, device=device)
    env = config["env"]
    budget = ref_cost.budget(layers.double(), env,
                             config["budget"]["platform_fraction"],
                             torch.float64)
    out = {k: 0 if k == "stage2_errors" else 0.0 for k in names}
    stalls = []
    details = {"policy_epochs": 0}
    for request, outcome in runs:
        if "rescore_gap" in names:
            out["rescore_gap"] = max(out["rescore_gap"], rescore_gap(
                outcome, layers, env, budget,
                torch.bfloat16 if control else None))
        if "policy_gap" in names:
            opts = request.options
            kw = dict(epochs=POLICY_EPOCHS,
                      episodes=int(opts.get("episodes_per_epoch", 1)),
                      lr=float(opts.get("lr", 3e-3)),
                      discount=float(opts.get("discount", 0.9)),
                      device=device)
            replayed = ref_policy.replay(config, request.seed, **kw)
            hist = outcome.extras.get("history") or {}
            if control:
                ctl = ref_policy.replay(config, request.seed, mode="tf32",
                                        **kw)
                hist = {k: [r[k] for r in ctl]
                        for k in ("loss", "mean_value", "best_value")}
            g, n = policy_gap(hist, replayed)
            out["policy_gap"] = max(out["policy_gap"], g)
            details["policy_epochs"] += n
        if "stage2_errors" in names:
            out["stage2_errors"] += stage2_errors(outcome, request)
        if "ga_stall" in names:
            stalls.append(ga_stall(outcome, request))
    stalls = [v for v in stalls if v is not None]
    if "ga_stall" in names and stalls:
        out["ga_stall"] = min(stalls)
    return {"numbers": out, "details": details}


def correct(numbers: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())
