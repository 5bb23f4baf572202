"""The port's A2C / PPO2 against the JAX package's, by replay, on the CPU.

JAX threefry keys and torch generators draw different numbers, so, as in
tests/test_torch_reinforce.py, the test runs one reference epoch (finite
pmin, non-zero Adam moments), rebuilds the next epoch's keys as
``repro/core/rl_baselines.py`` does (``key, sub = split(state.key)``,
``keys = split(sub, E)``), takes the reference rollout's sampled
``actions`` and feeds them, with the same params (critic included),
optimizer state and ``pmin``, into the port's epoch.  Rollout, GAE,
losses, gradients and the post-Adam state must then agree.  Sizes: ncf and
mobilenet_v2 cut to 6 layers, ``hidden=16``, E = 2.

Tolerances (the ones tests/test_torch_reinforce.py uses):
  * rewards: rtol 1e-5 plus atol 1e-6 x the largest |P_t|; perf rtol 1e-5;
    pmin rtol 1e-6; log-probs, values, observations rtol 1e-5, atol 1e-5;
  * GAE advantages and returns: rtol 1e-5, atol 1e-6 x the largest |P_t|
    (raw), 1e-4 (normalized: they divide by a std);
  * losses and gradients: rtol 1e-4, atol 1e-5; gradients also atol
    1e-6 x the largest |gradient| of the same array: unlike REINFORCE's
    standardized returns, the critic's loss is in raw return units
    (~1e5-1e6 here), so a float32 sum carries noise of that size into
    elements that cancel to a few hundred;
  * post-Adam params: atol 1e-5 per Adam step (A2C one, PPO2 four).
Within the port, chunked and resumed runs must give the bits of one run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as jenv
from repro.core import policy as jpolicy
from repro.core import rl_baselines as jrl
from repro.costmodel import workloads as jworkloads
from repro.training import optim as joptim
from repro_torch.core import env as tenv
from repro_torch.core import policy as tpolicy
from repro_torch.core import reinforce as treinforce
from repro_torch.core import rl_baselines as trl
from repro_torch.costmodel import workloads as tworkloads
from repro_torch.training import optim as toptim
from torch_threads import one_torch_thread  # noqa: F401,E402

E, HIDDEN = 2, 16


def _flat(tree):
    return {f"{g}.{n}": np.asarray(v) for g, d in tree.items()
            for n, v in d.items()}


def _jlosses(pcfg, acfg):
    """The reference's a2c_loss / ppo_loss (repro/core/rl_baselines.py)."""
    def parts(params, rolls, ret):
        lps, vs, ents = jax.vmap(
            lambda o, a: jrl.eval_sequence(params, pcfg, o, a))(
                rolls.obs, rolls.actions)
        vl = jnp.mean((jnp.square(vs - ret) * rolls.mask).sum(1))
        el = jnp.mean((ents * rolls.mask).sum(1))
        return lps, acfg.value_coef * vl - acfg.entropy_coef * el

    def a2c_loss(params, rolls, adv, ret):
        lps, rest = parts(params, rolls, ret)
        return -jnp.mean((lps * adv * rolls.mask).sum(1)) + rest

    def ppo_loss(params, rolls, adv, ret, logp_old):
        lps, rest = parts(params, rolls, ret)
        ratio = jnp.exp(lps - logp_old)
        un = ratio * adv
        cl = jnp.clip(ratio, 1 - acfg.clip_eps, 1 + acfg.clip_eps) * adv
        return -jnp.mean((jnp.minimum(un, cl) * rolls.mask).sum(1)) + rest

    return a2c_loss, ppo_loss


def _jadvantages(rolls, acfg):
    """The reference epoch's GAE + normalization, verbatim."""
    adv = jax.vmap(lambda r, v, m: jrl._gae(r, v, m, acfg.discount,
                                            acfg.gae_lambda))(
        rolls.rewards * rolls.mask, rolls.values * rolls.mask, rolls.mask)
    ret = adv + rolls.values * rolls.mask
    nv = jnp.maximum(rolls.mask.sum(), 1.0)
    am = (adv * rolls.mask).sum() / nv
    astd = jnp.sqrt((jnp.square(adv - am) * rolls.mask).sum() / nv)
    return adv, (adv - am) / (astd + 1e-8) * rolls.mask, ret


def _port_state(state_j, pcfg_t):
    t = lambda a: torch.from_numpy(np.array(a))
    pol = tpolicy.params_from_jax(jax.tree.map(np.asarray, state_j.params),
                                  pcfg_t)
    return treinforce.SearchState(
        params=pol,
        opt_state=toptim.OptState(
            t(state_j.opt_state.step),
            {k: t(v) for k, v in _flat(state_j.opt_state.mu).items()},
            {k: t(v) for k, v in _flat(state_j.opt_state.nu).items()}),
        pmin=t(state_j.pmin), best_value=t(state_j.best_value),
        best_pe_lvl=t(state_j.best_pe_lvl).long(),
        best_kt_lvl=t(state_j.best_kt_lvl).long(),
        best_df=t(state_j.best_df).long(),
        generator=torch.Generator(), epoch=t(state_j.epoch).long())


def _close(got, want, **tol):
    if torch.is_tensor(got):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **tol)


@pytest.mark.parametrize("algo,name,n_layers,scenario,mix", [
    ("a2c", "ncf", None, "LP", False),
    ("a2c", "mobilenet_v2", 6, "LS", False),
    ("a2c", "ncf", None, "LP", True),
    ("ppo2", "ncf", None, "LP", False),
    ("ppo2", "mobilenet_v2", 6, "LP", True),
])
def test_epoch_replay_matches_reference(algo, name, n_layers, scenario, mix):
    wl_j = jworkloads.get_workload(name)[:n_layers]
    wl_t = tworkloads.get_workload(name)[:n_layers]
    kw = dict(platform="iot", scenario=scenario, mix=mix)
    ecfg_j, ecfg_t = jenv.EnvConfig(**kw), tenv.EnvConfig(**kw)
    acfg_j = jrl.ACConfig(algo=algo, epochs=1, episodes_per_epoch=E, seed=5)
    acfg_t = trl.ACConfig(algo=algo, epochs=1, episodes_per_epoch=E, seed=5)
    pcfg_j = jpolicy.PolicyConfig(obs_dim=ecfg_j.obs_dim, mix=mix,
                                  hidden=HIDDEN, use_kernel=False)
    pcfg_t = tpolicy.PolicyConfig(obs_dim=ecfg_t.obs_dim, mix=mix,
                                  hidden=HIDDEN)
    env_j = jenv.make_env(wl_j, ecfg_j)
    env_t = tenv.make_env(wl_t, ecfg_t, device="cpu")

    # One reference epoch first; the second is replayed.
    state_j, _ = jrl.run_ac_search(wl_j, ecfg_j, acfg_j, pcfg_j)
    _, sub = jax.random.split(state_j.key)
    keys = jax.random.split(sub, E)
    rollout_j = jrl.make_ac_rollout(ecfg_j, pcfg_j, env_j)
    rolls_j = jax.vmap(lambda k: rollout_j(state_j.params, state_j.pmin,
                                           k))(keys)
    raw_adv_j, adv_j, ret_j = _jadvantages(rolls_j, acfg_j)
    a2c_j, ppo_j = _jlosses(pcfg_j, acfg_j)
    if algo == "a2c":
        loss_j, grads_j = jax.value_and_grad(a2c_j)(state_j.params, rolls_j,
                                                    adv_j, ret_j)
    else:
        loss_j, grads_j = jax.value_and_grad(ppo_j)(
            state_j.params, rolls_j, adv_j, ret_j, rolls_j.logps)
    new_j, hist_j = jrl.run_ac_search(wl_j, ecfg_j, acfg_j, pcfg_j,
                                      state=state_j)
    actions = torch.from_numpy(np.asarray(rolls_j.actions, np.int64))

    state_t = _port_state(state_j, pcfg_t)
    pol = state_t.params
    rolls_t = trl.make_ac_rollout(ecfg_t, pcfg_t, env_t)(
        pol, state_t.pmin, None, E, actions)
    scale = float(np.max(np.abs(np.asarray(rolls_j.perf))))
    _close(rolls_t.mask, rolls_j.mask)
    _close(rolls_t.obs, rolls_j.obs, rtol=1e-5, atol=1e-5)
    _close(rolls_t.rewards, rolls_j.rewards, rtol=1e-5, atol=1e-6 * scale)
    _close(rolls_t.perf, rolls_j.perf, rtol=1e-5)
    _close(rolls_t.values, rolls_j.values, rtol=1e-5, atol=1e-5)
    _close(rolls_t.logps, rolls_j.logps, rtol=1e-5, atol=1e-5)
    _close(rolls_t.feasible, rolls_j.feasible)
    _close(rolls_t.model_value, rolls_j.model_value, rtol=1e-5)
    _close(rolls_t.pmin, rolls_j.pmin, rtol=1e-6)

    raw_adv_t = trl._gae(rolls_t.rewards * rolls_t.mask,
                         rolls_t.values * rolls_t.mask, rolls_t.mask,
                         acfg_t.discount, acfg_t.gae_lambda)
    adv_t, ret_t = trl.advantages(rolls_t, acfg_t)
    _close(raw_adv_t, raw_adv_j, rtol=1e-5, atol=1e-6 * scale)
    _close(ret_t, ret_j, rtol=1e-5, atol=1e-6 * scale)
    _close(adv_t, adv_j, rtol=1e-4, atol=1e-4)

    a2c_t, ppo_t = trl.make_losses(pcfg_t, acfg_t)
    loss_t = (a2c_t(pol, rolls_t, adv_t, ret_t) if algo == "a2c"
              else ppo_t(pol, rolls_t, adv_t, ret_t, rolls_t.logps))
    _close(loss_t, loss_j, rtol=1e-4, atol=1e-5)
    named = dict(pol.named_parameters())
    assert set(named) == set(_flat(grads_j))
    grads_t = dict(zip(named, torch.autograd.grad(loss_t,
                                                  list(named.values()))))
    for k, g in _flat(grads_j).items():
        _close(grads_t[k], g, rtol=1e-4,
               atol=1e-5 + 1e-6 * float(np.max(np.abs(g))), err_msg=k)

    opt_t = toptim.Adam(lr=acfg_t.lr, clip_norm=1.0)
    new_t, metrics_t = trl.make_ac_epoch_fn(ecfg_t, pcfg_t, acfg_t, env_t,
                                            opt_t)(state_t, actions)
    updates = 1 if algo == "a2c" else acfg_t.ppo_updates
    for k, v in _flat(new_j.params).items():
        _close(named[k], v, atol=1e-5 * updates, err_msg=k)
    for k, v in _flat(new_j.opt_state.mu).items():
        _close(new_t.opt_state.mu[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert (int(new_t.opt_state.step) == int(new_j.opt_state.step)
            == 2 * updates)
    _close(new_t.pmin, new_j.pmin, rtol=1e-6)
    _close(new_t.best_value, new_j.best_value, rtol=1e-5)
    for k in ("best_pe_lvl", "best_kt_lvl", "best_df"):
        _close(getattr(new_t, k), getattr(new_j, k), err_msg=k)
    for k in ("best_value", "mean_value", "feasible_frac"):
        _close(metrics_t[k], hist_j[k][0], rtol=1e-5, err_msg=k)


def test_gae_matches_reference():
    rng = np.random.default_rng(0)
    r, v = (rng.standard_normal((3, 17)).astype(np.float32)
            for _ in range(2))
    m = (rng.random((3, 17)) < 0.8).astype(np.float32)
    want = jax.vmap(lambda a, b, c: jrl._gae(a, b, c, 0.9, 0.95))(r, v, m)
    got = trl._gae(*(torch.from_numpy(x) for x in (r, v, m)), 0.9, 0.95)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_clipped_adam_matches_reference():
    """The port's Adam with clip_norm=1.0 (the AC engines') against the
    reference's on gradients whose global norm exceeds 1 and on ones
    under it."""
    rng = np.random.default_rng(1)
    params = {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32)},
              "b": {"b": rng.standard_normal((3,)).astype(np.float32)}}
    opt_j = joptim.Adam(lr=1e-3, clip_norm=1.0)
    opt_t = toptim.Adam(lr=1e-3, clip_norm=1.0)
    flat = {k: torch.from_numpy(v.copy()) for k, v in _flat(params).items()}
    st_j, st_t = opt_j.init(params), opt_t.init(flat)
    for scale in (5.0, 0.01, 3.0):
        g = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                         .astype(np.float32), params)
        params, st_j = opt_j.update(g, st_j, params)
        flat, st_t = opt_t.update(
            {k: torch.from_numpy(v) for k, v in _flat(g).items()}, st_t,
            flat)
        for k, v in _flat(params).items():
            np.testing.assert_allclose(flat[k].numpy(), v, rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_critic_init_and_params_from_jax():
    """init_ac_params adds head_v (N(0, 1) x 0.01, zero bias) to the
    policy's init; params_from_jax carries head_v across when the tree has
    it, and the policy alone when it does not."""
    pcfg = tpolicy.PolicyConfig(obs_dim=10, hidden=HIDDEN)
    gen = torch.Generator()
    gen.manual_seed(0)
    pol = trl.init_ac_params(pcfg, gen)
    w = pol.head_v["w"].detach()
    assert w.shape == (HIDDEN, 1) and 0 < float(w.abs().max()) < 0.05
    assert torch.equal(pol.head_v["b"].detach(), torch.zeros(1))
    tree = jrl.init_ac_params(jax.random.PRNGKey(0), jpolicy.PolicyConfig(
        obs_dim=10, hidden=HIDDEN, use_kernel=False))
    tree = jax.tree.map(np.asarray, tree)
    got = tpolicy.params_from_jax(tree, pcfg)
    assert got.critic
    np.testing.assert_array_equal(got.head_v["w"].detach().numpy(),
                                  tree["head_v"]["w"])
    del tree["head_v"]
    assert not tpolicy.params_from_jax(tree, pcfg).critic


def test_mlp_critic_fails_as_the_reference_does():
    ecfg = tenv.EnvConfig(platform="cloud")
    pcfg = tpolicy.PolicyConfig(obs_dim=ecfg.obs_dim, kind="mlp")
    env = tenv.make_env(tworkloads.get_workload("ncf"), ecfg, device="cpu")
    with pytest.raises(ValueError, match="critic"):
        trl.make_ac_rollout(ecfg, pcfg, env)


def _small(algo, epochs=5):
    wl = tworkloads.get_workload("ncf")
    ecfg = tenv.EnvConfig(platform="iot")
    pcfg = tpolicy.PolicyConfig(obs_dim=ecfg.obs_dim, hidden=HIDDEN)
    acfg = trl.ACConfig(algo=algo, epochs=epochs, episodes_per_epoch=E,
                        ppo_updates=2, seed=3)
    return wl, ecfg, pcfg, acfg, tenv.make_env(wl, ecfg, device="cpu")


def _same_state(a, b):
    return (all(torch.equal(p, q) for p, q in zip(a.params.parameters(),
                                                  b.params.parameters()))
            and all(torch.equal(p, q) for p, q in zip(
                treinforce.state_tensors(a), treinforce.state_tensors(b)))
            and torch.equal(a.generator.get_state(),
                            b.generator.get_state()))


@pytest.mark.parametrize("algo", ["a2c", "ppo2"])
def test_chunked_and_resumed_runs_equal_one_run(algo):
    """5 epochs in chunks of 2, and 2 epochs then 3 more from the returned
    state, give the bits of 5 epochs in one run; the state a run is given,
    and the ones ``on_chunk`` got, are not moved by later epochs."""
    wl, ecfg, pcfg, acfg, env = _small(algo)
    whole, h5 = trl.run_ac_search(wl, ecfg, acfg, pcfg, env=env)
    seen = []
    chunked, hc = trl.run_ac_search(
        wl, ecfg, acfg, pcfg, env=env, chunk=2,
        on_chunk=lambda st, h, done: seen.append(
            (done, treinforce.clone_state(st), st)))
    assert [d for d, _, _ in seen] == [2, 4, 5]
    assert all(_same_state(copy, st) for _, copy, st in seen)
    first, h2 = trl.run_ac_search(wl, ecfg, dataclasses.replace(
        acfg, epochs=2), pcfg, env=env)
    saved = treinforce.clone_state(first)
    rest, h3 = trl.run_ac_search(wl, ecfg, dataclasses.replace(
        acfg, epochs=3), pcfg, state=first, env=env)
    assert _same_state(first, saved)
    assert _same_state(whole, chunked) and _same_state(whole, rest)
    for k in h5:
        assert hc[k].tobytes() == h5[k].tobytes(), k
        assert np.concatenate([h2[k], h3[k]]).tobytes() == h5[k].tobytes()
