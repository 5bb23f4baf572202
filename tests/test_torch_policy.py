"""The port's policy and Adam against the JAX package, on the CPU.

The reference's own ``init_params`` output is carried across with
``params_from_jax``; observations and states are made with numpy from a
seed.  Tolerance: atol 1e-5 (the LSTM kernel's bound in the reference's
tests), float32 throughout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpolicy
from repro.training import optim as joptim
from repro_torch.core import policy as tpolicy
from repro_torch.training import optim as toptim


def _cfgs(kind, mix):
    kw = dict(obs_dim=11 if mix else 10, mix=mix, kind=kind)
    return jpolicy.PolicyConfig(use_kernel=False, **kw), \
        tpolicy.PolicyConfig(**kw)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("batch", [(), (4,)])
@pytest.mark.parametrize("kind,mix", [("rnn", False), ("rnn", True),
                                      ("mlp", False)])
def test_step_matches_reference(kind, mix, batch):
    jcfg, tcfg = _cfgs(kind, mix)
    params = jpolicy.init_params(jax.random.PRNGKey(3), jcfg)
    pol = tpolicy.params_from_jax(_tree_np(params), tcfg)
    rng = np.random.default_rng(5)
    obs = rng.uniform(-1, 1, (*batch, jcfg.obs_dim)).astype(np.float32)
    h = (rng.standard_normal((*batch, 128)) * 0.1).astype(np.float32)
    c = (rng.standard_normal((*batch, 128)) * 0.1).astype(np.float32)
    jlog, jstate = jpolicy.step(params, jcfg, jnp.asarray(obs),
                                jpolicy.LSTMState(jnp.asarray(h),
                                                  jnp.asarray(c)))
    tlog, tstate = pol(torch.from_numpy(obs),
                       tpolicy.LSTMState(torch.from_numpy(h),
                                         torch.from_numpy(c)))
    assert len(tlog) == len(jlog) == (3 if mix else 2)
    for t, j in zip(tlog, jlog):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=1e-5)
    for t, j in zip(tstate, jstate):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=1e-5)


def test_params_from_jax_keeps_layout_and_rejects_mismatch():
    jcfg, tcfg = _cfgs("rnn", False)
    params = _tree_np(jpolicy.init_params(jax.random.PRNGKey(0), jcfg))
    pol = tpolicy.params_from_jax(params, tcfg)
    for group, names in params.items():
        for name, val in names.items():
            np.testing.assert_array_equal(
                getattr(pol, group)[name].detach().numpy(), val)
    bad = dict(params, lstm=dict(params["lstm"], wx=params["lstm"]["wx"][:3]))
    with pytest.raises(ValueError, match="shape"):
        tpolicy.params_from_jax(bad, tcfg)


def test_init_params_layout_matches_reference():
    """Same shapes, forget-gate bias 1.0, zero head biases."""
    for kind, mix in (("rnn", False), ("rnn", True), ("mlp", False)):
        jcfg, tcfg = _cfgs(kind, mix)
        ref = _tree_np(jpolicy.init_params(jax.random.PRNGKey(0), jcfg))
        pol = tpolicy.init_params(tcfg, torch.Generator().manual_seed(0))
        for group, names in ref.items():
            for name, val in names.items():
                got = getattr(pol, group)[name].detach().numpy()
                assert got.shape == val.shape, (group, name)
                if val.ndim == 1:
                    np.testing.assert_array_equal(got, val)


def test_sample_action_is_a_valid_categorical_draw():
    logits = torch.tensor([[0.0, 5.0, -5.0], [3.0, 0.0, 0.0]])
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([tpolicy.sample_action(gen, logits)[0]
                         for _ in range(400)])
    freq1 = (draws[:, 0] == 1).float().mean().item()
    freq0 = (draws[:, 1] == 0).float().mean().item()
    p = torch.softmax(logits, -1)
    assert abs(freq1 - p[0, 1].item()) < 0.05
    assert abs(freq0 - p[1, 0].item()) < 0.08
    a, lp, ent = tpolicy.sample_action(gen, logits)
    np.testing.assert_allclose(
        lp.numpy(), torch.log_softmax(logits, -1).gather(
            -1, a[:, None])[:, 0].numpy())
    assert (ent > 0).all()


@pytest.mark.parametrize("steps", [1, 3])
def test_adam_update_matches_reference(steps):
    rng = np.random.default_rng(11)
    params = {"w": rng.standard_normal((10, 12)).astype(np.float32),
              "b": rng.standard_normal((12,)).astype(np.float32)}
    jopt = joptim.Adam(lr=3e-3)
    topt = toptim.Adam(lr=3e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(steps):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        tp, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
    assert int(ts.step) == int(js.step) == steps
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]),
                                   rtol=1e-6, atol=1e-7)
