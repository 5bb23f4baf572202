"""One REINFORCE epoch of the port against the JAX package, by replay.

JAX threefry keys and torch generators draw different numbers, so the
port's epoch cannot reproduce the reference's from a seed.  Instead the
test builds the reference epoch's keys exactly as
``repro/core/reinforce.py`` does (``key, sub = split(state.key)``,
``keys = split(sub, E)``), takes the reference rollout's sampled
``actions``, and feeds them, the same params, optimizer state and ``pmin``
into the port's epoch.  Rewards, mask, returns, loss, gradients and the
post-Adam state must then agree.

Tolerances (float32, different summation orders):
  * rewards, returns: rtol 1e-5 plus atol 1e-6 x the largest |P_t| -- a
    reward is a difference of two per-layer costs of that size;
  * loss and gradients: rtol 1e-4, atol 1e-5 -- sums of 2E x N terms whose
    standardized returns carry the reward error;
  * post-Adam params and moments: atol 1e-5 (lr 3e-3 times the Adam step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as jenv
from repro.core import policy as jpolicy
from repro.core import reinforce as jreinforce
from repro.costmodel import workloads as jworkloads
from repro.training import optim as joptim
from repro_torch.core import env as tenv
from repro_torch.core import policy as tpolicy
from repro_torch.core import reinforce as treinforce
from repro_torch.costmodel import workloads as tworkloads
from repro_torch.training import optim as toptim
from torch_threads import one_torch_thread  # noqa: F401,E402

E = 2


def _jloss(ecfg, pcfg, rcfg, env, rollout, pmin, keys):
    """The reference's loss_fn (repro/core/reinforce.py), to get its grads."""
    def loss_fn(params):
        rolls = jax.vmap(lambda k: rollout(params, pmin, k))(keys)
        G = jax.vmap(lambda r: jreinforce._discounted_returns(
            r, rcfg.discount))(rolls.rewards * rolls.mask)
        n_valid = jnp.maximum(rolls.mask.sum(axis=1), 1.0)
        mean = (G * rolls.mask).sum(axis=1) / n_valid
        var = (jnp.square(G - mean[:, None]) * rolls.mask).sum(
            axis=1) / n_valid
        G_std = (G - mean[:, None]) / (jnp.sqrt(var)[:, None] + 1e-8)
        pg = -(rolls.logps * jax.lax.stop_gradient(G_std)
               * rolls.mask).sum(axis=1)
        ent = (rolls.entropy * rolls.mask).sum(axis=1)
        loss = jnp.mean(pg) - rcfg.entropy_coef * jnp.mean(ent)
        return loss, (rolls, G)
    return loss_fn


def _flat(tree):
    return {f"{g}.{n}": np.asarray(v) for g, d in tree.items()
            for n, v in d.items()}


@pytest.mark.parametrize("name,n_layers,scenario,mix", [
    ("ncf", None, "LP", False),
    ("ncf", None, "LS", False),
    ("mobilenet_v2", 6, "LP", False),
    ("mobilenet_v2", 6, "LS", False),
    ("ncf", None, "LP", True),
])
def test_epoch_replay_matches_reference(name, n_layers, scenario, mix):
    wl_j = jworkloads.get_workload(name)[:n_layers]
    wl_t = tworkloads.get_workload(name)[:n_layers]
    kw = dict(platform="iot", scenario=scenario, mix=mix)
    ecfg_j, ecfg_t = jenv.EnvConfig(**kw), tenv.EnvConfig(**kw)
    rcfg_j = jreinforce.ReinforceConfig(epochs=2, episodes_per_epoch=E,
                                        entropy_coef=0.01, seed=4)
    rcfg_t = treinforce.ReinforceConfig(epochs=2, episodes_per_epoch=E,
                                        entropy_coef=0.01, seed=4)
    pcfg_j = jpolicy.PolicyConfig(obs_dim=ecfg_j.obs_dim, mix=mix,
                                  use_kernel=False)
    pcfg_t = tpolicy.PolicyConfig(obs_dim=ecfg_t.obs_dim, mix=mix)
    env_j = jenv.make_env(wl_j, ecfg_j)
    env_t = tenv.make_env(wl_t, ecfg_t, device="cpu")
    opt_j, opt_t = joptim.Adam(lr=rcfg_j.lr), toptim.Adam(lr=rcfg_t.lr)

    # One reference epoch first, so pmin is finite and Adam's moments are
    # not zero; the second epoch is replayed.
    epoch_j = jax.jit(jreinforce.make_epoch_fn(ecfg_j, pcfg_j, rcfg_j, env_j,
                                               opt_j))
    state_j, _ = epoch_j(jreinforce.init_search(env_j, ecfg_j, pcfg_j, rcfg_j,
                                                opt_j), None)
    _, sub = jax.random.split(state_j.key)
    keys = jax.random.split(sub, E)
    rollout_j = jreinforce.make_rollout(ecfg_j, pcfg_j, env_j,
                                        rcfg_j.discount)
    (loss_j, (rolls_j, G_j)), grads_j = jax.value_and_grad(
        _jloss(ecfg_j, pcfg_j, rcfg_j, env_j, rollout_j, state_j.pmin, keys),
        has_aux=True)(state_j.params)
    new_j, metrics_j = epoch_j(state_j, None)
    actions = torch.from_numpy(np.asarray(rolls_j.actions, np.int64))

    # The port's state, carried across from the reference's.
    pol = tpolicy.params_from_jax(jax.tree.map(np.asarray, state_j.params),
                                  pcfg_t)
    t = lambda a: torch.from_numpy(np.array(a))
    state_t = treinforce.SearchState(
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

    loss_fn = treinforce.make_loss_fn(ecfg_t, pcfg_t, rcfg_t, env_t)
    loss_t, rolls_t, G_t = loss_fn(pol, state_t.pmin, None, actions)
    scale = float(np.max(np.abs(np.asarray(rolls_j.perf))))
    close = lambda got, want, **tol: np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), **tol)
    close(rolls_t.mask, rolls_j.mask)
    close(rolls_t.rewards, rolls_j.rewards, rtol=1e-5, atol=1e-6 * scale)
    close(G_t, G_j, rtol=1e-5, atol=1e-6 * scale)
    close(rolls_t.perf, rolls_j.perf, rtol=1e-5)
    close(rolls_t.feasible, rolls_j.feasible)
    close(rolls_t.pmin, rolls_j.pmin, rtol=1e-6)
    close(rolls_t.logps, rolls_j.logps, rtol=1e-5, atol=1e-5)
    close(loss_t, loss_j, rtol=1e-4, atol=1e-5)
    close(loss_t, metrics_j["loss"], rtol=1e-4, atol=1e-5)
    named = dict(pol.named_parameters())
    grads_t = dict(zip(named, torch.autograd.grad(loss_t,
                                                  list(named.values()))))
    for k, g in _flat(grads_j).items():
        close(grads_t[k], g, rtol=1e-4, atol=1e-5, err_msg=k)

    new_t, metrics_t = treinforce.make_epoch_fn(
        ecfg_t, pcfg_t, rcfg_t, env_t, opt_t)(state_t, actions)
    for k, v in _flat(new_j.params).items():
        close(named[k], v, atol=1e-5, err_msg=k)
    for k, v in _flat(new_j.opt_state.mu).items():
        close(new_t.opt_state.mu[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    assert int(new_t.opt_state.step) == int(new_j.opt_state.step) == 2
    close(new_t.pmin, new_j.pmin, rtol=1e-6)
    close(new_t.best_value, new_j.best_value, rtol=1e-5)
    close(new_t.best_pe_lvl, new_j.best_pe_lvl)
    close(new_t.best_kt_lvl, new_j.best_kt_lvl)
    close(new_t.best_df, new_j.best_df)
    for k in ("best_value", "mean_value", "feasible_frac", "mean_return"):
        close(metrics_t[k], metrics_j[k], rtol=1e-5, err_msg=k)


def test_discounted_returns_match_reference():
    rng = np.random.default_rng(0)
    r = rng.standard_normal((3, 17)).astype(np.float32)
    want = jax.vmap(lambda x: jreinforce._discounted_returns(x, 0.9))(r)
    got = treinforce._discounted_returns(torch.from_numpy(r), 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _small_stage1(name, E, mix, epochs=5, seed=3):
    """A 5-layer stage-1 setup on the CPU: ncf, or the first 5 layers of
    mobilenet_v2."""
    wl = tworkloads.get_workload(name)[:5]
    ecfg = tenv.EnvConfig(platform="iot", mix=mix)
    pcfg = tpolicy.PolicyConfig(obs_dim=ecfg.obs_dim, mix=mix)
    rcfg = treinforce.ReinforceConfig(epochs=epochs, episodes_per_epoch=E,
                                      seed=seed)
    return wl, ecfg, pcfg, rcfg, tenv.make_env(wl, ecfg, device="cpu")


def _assert_same_state(a, b):
    assert all(torch.equal(p, q) for p, q in zip(a.params.parameters(),
                                                 b.params.parameters()))
    assert all(torch.equal(p, q) for p, q in zip(
        treinforce.state_tensors(a), treinforce.state_tensors(b)))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("mix", [False, True])
@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("name", ["ncf", "mobilenet_v2"])
def test_inplace_epoch_gives_the_bits_of_make_epoch_fn(name, E, mix):
    """Five epochs written back in place (the form the CUDA graph
    captures) against five epochs of ``make_epoch_fn``: the same metrics
    and the same state, bit for bit, in the same buffers throughout."""
    wl, ecfg, pcfg, rcfg, env = _small_stage1(name, E, mix)
    opt = toptim.Adam(lr=rcfg.lr)
    eager = treinforce.init_search(env, ecfg, pcfg, rcfg, opt)
    inplace = treinforce.init_search(env, ecfg, pcfg, rcfg, opt)
    buffers = [t.data_ptr() for t in treinforce.state_tensors(inplace)]
    epoch_fn = treinforce.make_epoch_fn(ecfg, pcfg, rcfg, env, opt)
    epoch_ = treinforce.make_inplace_epoch_fn(ecfg, pcfg, rcfg, env, opt)
    metrics = torch.zeros(len(treinforce.METRICS))
    for _ in range(rcfg.epochs):
        eager, m = epoch_fn(eager)
        epoch_(inplace, metrics)
        assert torch.equal(metrics, torch.stack(
            [m[k] for k in treinforce.METRICS]))
    _assert_same_state(eager, inplace)
    assert buffers == [t.data_ptr()
                       for t in treinforce.state_tensors(inplace)]
    assert int(inplace.epoch) == rcfg.epochs


@pytest.mark.parametrize("chunk", [2, 5])
def test_stage1_resumes_across_chunks_bit_identically(chunk):
    """Stage 1 run as 2 epochs then 3 more from the returned state gives
    the bits of 5 epochs in one run, in chunks of ``chunk``; the states
    handed to ``on_chunk`` are copies that later epochs leave alone."""
    wl, ecfg, pcfg, rcfg, env = _small_stage1("ncf", 2, False)
    seen = []
    whole, h5 = treinforce.run_search(
        wl, ecfg, rcfg, pcfg, chunk=chunk, device="cpu", env=env,
        on_chunk=lambda st, h, done: seen.append((done, float(st.epoch))))
    assert seen == [(d, float(d)) for d in range(chunk, 5, chunk)] + [
        (5, 5.0)]
    first, h2 = treinforce.run_search(
        wl, ecfg, dataclasses.replace(rcfg, epochs=2), pcfg, device="cpu",
        env=env)
    saved = treinforce.clone_state(first)
    rest, h3 = treinforce.run_search(
        wl, ecfg, dataclasses.replace(rcfg, epochs=3), pcfg, state=first,
        device="cpu", env=env)
    _assert_same_state(first, saved)          # the given state is not moved
    _assert_same_state(whole, rest)
    for k in treinforce.METRICS:
        assert np.concatenate([h2[k], h3[k]]).tobytes() == h5[k].tobytes(), k
