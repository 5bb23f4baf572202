"""The port's relaxed engine against the JAX package's, on the CPU.

The reference's ``_init_state`` (threefry draws) is carried across with
``relaxed_state_from_jax``, so both engines start from the same logits.
The reference arm runs op by op (``jax.disable_jit()``).  Jitted, XLA
fuses the soft model's float32 arithmetic differently, and the soft
staircase's gradient reads ``frac(a / b)`` of quotients up to ~1e4, where
one ulp of the quotient moves the gradient by ~1e-3 relative: the
reference's jitted gradients at the initial state differ from its own
op-by-op ones by up to 4e-4 relative on ncf / cloud, and the descent
amplifies that to 1e-2 in the logits within five steps.  Against the
op-by-op reference:

  * one round (5 Adam steps through the soft model, the anneal, the pick
    of the best replica and its rounding) against the reference's
    ``round_fn``: params within atol 1e-4, rtol 1e-4 (each step moves a
    logit by up to lr = 0.05; they agree to ~2e-7), Adam moments within
    rtol 1e-4 (atol 1e-4 x the array's largest |value|), tau and the step
    count exact, and the same rounded candidate, exactly;
  * a short run from that state, one round (of one Adam step) and the
    four rounding variants: the same history and best fitness (rtol 1e-5, the hard
    model's bound), and the same best assignment.  Longer runs part ways:
    the best replica's argmin and its rounding are discontinuous, so the
    float32 noise above picks another candidate within a few rounds (ncf /
    cloud: the fourth round's), and from there the trajectories differ.

Within the port, as tests/test_relaxed.py checks for the reference: chunk
boundaries, an injected ``eval_fn`` and a resume leave the bytes alone.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import env as jenv
from repro.core import relaxed as jrelaxed
from repro.costmodel import workloads as jworkloads
from repro_torch.core import env as tenv
from repro_torch.core import relaxed as trelaxed
from repro_torch.costmodel import dataflows as tdfl
from repro_torch.costmodel import workloads as tworkloads
from torch_threads import one_torch_thread  # noqa: F401,E402

CFG = dict(steps_per_eval=5, restarts=2, seed=7)
SHORT_STEPS = 1
CASES = [
    ("ncf", None, dict(platform="cloud")),
    ("mobilenet_v2", 6, dict(platform="iot", scenario="LS", mix=True)),
    ("ncf", None, dict(platform="unlimited", mix=True,
                       objective="energy", constraint="power")),
]


def _setup(name, n_layers, kw, **cfg):
    ecfg_j, ecfg_t = jenv.EnvConfig(**kw), tenv.EnvConfig(**kw)
    wl_j = jworkloads.get_workload(name)[:n_layers]
    wl_t = tworkloads.get_workload(name)[:n_layers]
    cfg_j = jrelaxed.RelaxedConfig(**{**CFG, **cfg})
    cfg_t = trelaxed.RelaxedConfig(**{**CFG, **cfg})
    env_j = jenv.make_env(wl_j, ecfg_j)
    env_t = tenv.make_env(wl_t, ecfg_t, device="cpu")
    state_j = jrelaxed._init_state(env_j, cfg_j)
    state_t = trelaxed.relaxed_state_from_jax(
        jax.tree.map(np.asarray, state_j))
    return (ecfg_j, ecfg_t, cfg_j, cfg_t, env_j, env_t, wl_j, wl_t,
            state_j, state_t)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("name,n_layers,kw", CASES)
def test_one_round_matches_reference(name, n_layers, kw):
    (ecfg_j, ecfg_t, cfg_j, cfg_t, env_j, env_t, _, _, state_j,
     state_t) = _setup(name, n_layers, kw)
    for a, b in zip(state_t.params, state_j.params):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    round_j, best_j = jrelaxed.make_round_fn(env_j, ecfg_j, cfg_j)
    round_t, best_t = trelaxed.make_round_fn(env_t, ecfg_t, cfg_t)
    with jax.disable_jit():
        new_j, *cand_j = round_j(state_j)
        cont_j = best_j(new_j)
    new_t, *cand_t = round_t(state_t)
    for field in ("params", "m", "v"):
        for i, (a, b) in enumerate(zip(getattr(new_t, field),
                                       getattr(new_j, field))):
            b = np.asarray(b)
            atol = 1e-4 * (1.0 if field == "params"
                           else float(np.max(np.abs(b))))
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=atol,
                                       err_msg=f"{field}[{i}]")
    assert np.float32(new_t.tau) == np.float32(new_j.tau)
    assert int(new_t.gstep) == int(new_j.gstep) == CFG["steps_per_eval"]
    for a, b in zip(cand_t, cand_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(best_t(new_t), cont_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name,n_layers,kw", [CASES[0], CASES[2]])
def test_short_run_matches_reference(name, n_layers, kw):
    """5 hard evaluations (1 round of one Adam step + 4 rounding variants)
    from the same initial state: the same history, best fitness and
    assignment.  One step a round: the round itself is held at 5 steps
    above, and the op-by-op reference's steps are the slow part."""
    (ecfg_j, ecfg_t, cfg_j, cfg_t, env_j, env_t, wl_j, wl_t, state_j,
     state_t) = _setup(name, n_layers, kw, steps_per_eval=SHORT_STEPS)
    with jax.disable_jit():
        sj, hj = jrelaxed.run_relaxed_search(wl_j, ecfg_j, 5, cfg_j,
                                             state=state_j, env=env_j)
    st, ht = trelaxed.run_relaxed_search(wl_t, ecfg_t, 5, cfg_t,
                                         state=state_t, env=env_t)
    np.testing.assert_array_equal(np.isinf(ht), np.isinf(hj))
    np.testing.assert_allclose(ht, hj, rtol=1e-5)
    assert np.isfinite(float(st.best_fit))
    np.testing.assert_allclose(float(st.best_fit), float(sj.best_fit),
                               rtol=1e-5)
    for a, b in zip(trelaxed.relaxed_solution(st),
                    jrelaxed.relaxed_solution(sj)):
        np.testing.assert_array_equal(a, b)
    assert int(st.evals) == int(sj.evals) == 5
    assert int(st.gstep) == int(sj.gstep) == SHORT_STEPS


def test_relaxed_state_from_jax_round_trips_every_field():
    *_, state_j, state_t = _setup("ncf", None, dict(platform="cloud"))
    for field in trelaxed.RelaxedState._fields:
        a, b = getattr(state_t, field), getattr(state_j, field)
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # The best and the count stay on the host; the descent on the device.
    assert state_t.best_fit.device.type == "cpu"
    assert state_t.evals.dtype == torch.int64


# ---------------------------------------------------------------------------
# The chunked / resumable / injectable contract, within the port.
# ---------------------------------------------------------------------------
ECFG = tenv.EnvConfig(platform="cloud")
PORT_CFG = trelaxed.RelaxedConfig(**CFG)


@pytest.fixture(scope="module")
def ncf_env():
    wl = tworkloads.get_workload("ncf")
    return wl, tenv.make_env(wl, ECFG, device="cpu")


@pytest.mark.parametrize("chunk", [1, 7])
def test_chunk_boundaries_never_change_bytes(ncf_env, chunk):
    wl, env = ncf_env
    seen = []
    s1, h1 = trelaxed.run_relaxed_search(wl, ECFG, 30, PORT_CFG, env=env)
    s3, h3 = trelaxed.run_relaxed_search(
        wl, ECFG, 30, PORT_CFG, chunk=chunk, env=env,
        on_chunk=lambda st, h, done: seen.append(done))
    assert h1.tobytes() == h3.tobytes() and h1.shape == (30,)
    assert int(s3.evals) == 30
    # The variant tail reports the evaluations past the descent rounds.
    assert seen[-1] == 30 and seen[-2] == 26
    for a, b in zip(trelaxed.relaxed_solution(s1),
                    trelaxed.relaxed_solution(s3)):
        assert a.tobytes() == b.tobytes()


def test_eval_fn_injection_is_byte_identical(ncf_env):
    wl, env = ncf_env
    calls = []

    def eval_fn(pe, kt, df):
        calls.append((pe.shape, np.shape(df)))
        perf, _, feas = tenv.genome_cost(env, ECFG, torch.from_numpy(pe),
                                         torch.from_numpy(kt),
                                         torch.as_tensor(df))
        return torch.where(feas, perf, torch.inf).numpy()

    s1, h1 = trelaxed.run_relaxed_search(wl, ECFG, 25, PORT_CFG, env=env)
    s2, h2 = trelaxed.run_relaxed_search(wl, ECFG, 25, PORT_CFG,
                                         eval_fn=eval_fn, env=env)
    assert h1.tobytes() == h2.tobytes()
    assert len(calls) == 25            # eps counts hard evals, exactly
    assert calls[0] == ((1, env.num_layers), ())   # the env's dataflow
    assert float(s1.best_fit) == float(s2.best_fit)


def test_resume_continues_the_trajectory(ncf_env):
    wl, env = ncf_env
    sa, ha = trelaxed.run_relaxed_search(wl, ECFG, 15, PORT_CFG, env=env)
    saved = [t.clone() for t in sa.params]
    sb, hb = trelaxed.run_relaxed_search(wl, ECFG, 15, PORT_CFG, state=sa,
                                         env=env)
    assert all(torch.equal(a, b) for a, b in zip(sa.params, saved))
    assert int(sa.evals) == 15 and int(sb.evals) == 30
    assert int(sb.gstep) > int(sa.gstep)
    assert float(sb.best_fit) <= float(sa.best_fit)
    assert ha.shape == hb.shape == (15,)
    # The same 15 more evaluations again from the same state: same bytes.
    sc, hc = trelaxed.run_relaxed_search(wl, ECFG, 15, PORT_CFG, state=sa,
                                         env=env)
    assert hb.tobytes() == hc.tobytes()


def test_finds_a_feasible_rounded_point(ncf_env):
    wl, env = ncf_env
    state, _ = trelaxed.run_relaxed_search(
        wl, ECFG, 40, dataclasses.replace(PORT_CFG), env=env)
    pe, kt, df = trelaxed.relaxed_solution(state)
    perf, _, feas = tenv.genome_cost(env, ECFG, torch.from_numpy(pe),
                                     torch.from_numpy(kt),
                                     torch.from_numpy(df))
    assert bool(feas) and float(perf) == float(state.best_fit)
    assert np.all((pe >= tdfl.PE_MIN) & (pe <= tdfl.PE_MAX))
    assert np.all((kt >= tdfl.KT_MIN) & (kt <= tdfl.KT_MAX))
    assert np.all(pe == np.round(pe)) and np.all(kt == np.round(kt))
