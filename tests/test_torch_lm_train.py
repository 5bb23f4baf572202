"""The port's LM loss, gradients, train steps and optimizers against the
JAX package, on the CPU.

Weights are the reference tree drawn with numpy
(``test_torch_lm.reference_tree``), carried across with
``lm.params_from_jax`` as float32 master weights (``dtype=float32``), the
layout of the reference's ``init_params``; batches are numpy draws.

Tolerances, float32 (only the order of sums differs):
* loss: atol 1e-5;
* gradients: atol 1e-6 plus rtol 1e-4 of each leaf (the largest entries
  here are ~0.05);
* parameters after an Adam step: atol 0.05 x lr.  The first step moves
  an entry by lr x g / (|g| + eps) with eps = 1e-8, so where |g| is within
  a few eps of zero a different order of the float32 sums moves that ratio
  by a large fraction of 1; elsewhere it is +-1 to within rounding.  No
  relative tolerance can hold such entries, and a bound of a fraction of
  lr still fails any wrong sign, scale, decay or schedule.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.training import optim as joptim
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.training import optim
from test_torch_lm import _f32, reference_tree

B, T = 2, 16
LR = 1e-3


def _batch(cfg, seed=5, batch=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, T + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if lm.cross_sites(cfg):
        S = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_seq
        key = "frames" if cfg.family == "audio" else "patches"
        out[key] = rng.standard_normal((batch, S, cfg.d_model)).astype(
            np.float32)
    return out


def _torch_batch(batch):
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)) for k, v in batch.items()}


def _leaf(tree, name):
    """The reference tree's entry for the port's parameter ``name``."""
    path, idx = lm.jax_name(name)
    val = tree
    for key in path:
        val = val[key]
    return np.asarray(val)[idx] if idx else np.asarray(val)


def _model(arch, compute="float32"):
    cfg = dataclasses.replace(_f32(configs.get_smoke(arch)),
                              compute_dtype=compute)
    jcfg = dataclasses.replace(_f32(jconfigs.get_smoke(arch)),
                               compute_dtype=compute)
    tree = reference_tree(jcfg)
    return cfg, jcfg, tree, lm.params_from_jax(tree, cfg,
                                               dtype=torch.float32)


def _launcher_opts():
    """The launcher's optimizer in both packages (warm-up 2 of 10 steps)."""
    return (joptim.Adam(lr=joptim.cosine_schedule(LR, 2, 10),
                        weight_decay=0.01, clip_norm=1.0),
            optim.Adam(lr=optim.cosine_schedule(LR, 2, 10),
                       weight_decay=0.01, clip_norm=1.0))


# One model per family: dense (qwen2.5: QKV bias, GQA), MoE (phi3.5: top-2
# of 4 with its capacity drops), SSM, hybrid, audio (the encoder's
# gradient through cross-attention), vlm.
@pytest.mark.parametrize("arch", ["qwen2p5_3b", "phi3p5_moe_42b",
                                  "mamba2_130m", "zamba2_1p2b",
                                  "whisper_small", "llama3p2_vision_90b"])
def test_loss_gradients_match_reference(arch):
    cfg, jcfg, tree, model = _model(arch)
    batch = _batch(cfg)
    aux = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, jcfg, b["tokens"], b["labels"],
                                 {k: b[k] for k in aux} or None,
                                 remat=False)))(
        jax.tree.map(jnp.asarray, tree), batch)
    named = lm._trainable(model)
    loss, grads = lm._loss_and_grads(model, named, cfg,
                                     _torch_batch(batch), None, True)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5, rtol=0)
    for name, g in grads.items():
        want = _leaf(jgrads, name)
        np.testing.assert_allclose(g.numpy(), want, atol=1e-6, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("arch,n_micro", [("qwen1p5_0p5b", 1),
                                          ("qwen3_moe_235b", 2)])
def test_train_steps_match_reference(arch, n_micro):
    """Two steps of ``train_step_accum`` (``train_step`` at n_micro = 1)
    with the launcher's optimizer: losses, parameters and moments (the
    first moment is 0.1 x the clipped gradient after the first step), and
    every output dtype (float32, as the reference's are)."""
    cfg, jcfg, tree, model = _model(arch)
    jopt, opt = _launcher_opts()
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    state = opt.init(dict(model.named_parameters()))
    jstep = jax.jit(lambda p, s, b: jlm.train_step_accum(
        p, s, b, jcfg, jopt, n_micro=n_micro))
    for step in range(2):
        batch = _batch(cfg, seed=10 + step, batch=4)
        jparams, jstate, jloss = jstep(jparams, jstate, batch)
        model, state, loss = lm.train_step_accum(
            model, state, _torch_batch(batch), cfg, opt, n_micro=n_micro)
        np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                                   rtol=0)
    assert loss.dtype == torch.float32 and jloss.dtype == jnp.float32
    assert int(state.step) == int(jstate.step) == 2
    for name, p in model.named_parameters():
        assert p.dtype == state.mu[name].dtype == torch.float32
        assert _leaf(jparams, name).dtype == np.float32
        np.testing.assert_allclose(p.detach().numpy(), _leaf(jparams, name),
                                   atol=0.05 * LR, rtol=0, err_msg=name)
        np.testing.assert_allclose(state.mu[name].numpy(),
                                   _leaf(jstate.mu, name), atol=1e-6,
                                   rtol=1e-3, err_msg=name)


def test_bf16_compute_keeps_float32_master_weights():
    """In a bfloat16-compute model the reference's parameters are float32
    (its init makes every leaf float32) and stay so through
    ``train_step_accum`` with n_micro = 2 (float32 accumulators); the
    port's master weights, moments and loss are float32 likewise, and its
    loss agrees to bfloat16's rounding (~1e-2 relative at most)."""
    cfg, jcfg, tree, model = _model("qwen1p5_0p5b", compute="bfloat16")
    jopt, opt = _launcher_opts()
    batch = _batch(cfg, batch=4)
    jparams = jax.tree.map(jnp.asarray, tree)
    jparams, jstate, jloss = jax.jit(lambda p, s, b: jlm.train_step_accum(
        p, s, b, jcfg, jopt, n_micro=2))(jparams, jopt.init(jparams), batch)
    state = opt.init(dict(model.named_parameters()))
    model, state, loss = lm.train_step_accum(
        model, state, _torch_batch(batch), cfg, opt, n_micro=2)
    assert {str(leaf.dtype) for leaf in jax.tree.leaves(
        (jparams, jstate.mu, jstate.nu, jloss))} == {"float32"}
    assert {t.dtype for t in (*model.parameters(), *state.mu.values(),
                              *state.nu.values(), loss)} == {torch.float32}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-2)


def _trees(seed, shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(dtype)
            for k, s in shapes.items()}


SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}


@pytest.mark.parametrize("kind", ["adamw_cosine", "adam_float", "sgd"])
def test_optimizers_match_reference(kind):
    """Three updates of random params: AdamW with the launcher's cosine
    schedule and clipping, plain Adam at a float lr, SGD with momentum."""
    if kind == "adamw_cosine":
        jopt = joptim.Adam(lr=joptim.cosine_schedule(0.1, 2, 6, floor=0.01),
                           weight_decay=0.05, clip_norm=0.5)
        opt = optim.Adam(lr=optim.cosine_schedule(0.1, 2, 6, floor=0.01),
                         weight_decay=0.05, clip_norm=0.5)
    elif kind == "adam_float":
        jopt, opt = joptim.Adam(lr=0.01), optim.Adam(lr=0.01)
    else:
        jopt = joptim.SGD(lr=joptim.cosine_schedule(0.1, 1, 6), momentum=0.9)
        opt = optim.SGD(lr=optim.cosine_schedule(0.1, 1, 6), momentum=0.9)
    params = _trees(0, SHAPES)
    jp, p = dict(params), {k: torch.from_numpy(v) for k, v in params.items()}
    js, s = jopt.init(jp), opt.init(p)
    jupdate = jax.jit(jopt.update)
    for i in range(3):
        g = _trees(1 + i, SHAPES)
        jp, js = jupdate(g, js, jp)
        p, s = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, s,
                          p)
    for k in SHAPES:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(s.mu[k].numpy(), np.asarray(js.mu[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)


def test_adam_in_place_equals_functional_bits():
    opt = optim.Adam(lr=optim.cosine_schedule(0.1, 2, 6), weight_decay=0.05,
                     clip_norm=0.5)
    p = {k: torch.from_numpy(v) for k, v in _trees(0, SHAPES).items()}
    q = {k: v.clone() for k, v in p.items()}
    s = opt.init(p)
    s2 = optim.OptState(s.step.clone(), {k: v.clone() for k, v in
                                         s.mu.items()},
                        {k: v.clone() for k, v in s.nu.items()})
    for i in range(3):
        g = {k: torch.from_numpy(v) for k, v in _trees(1 + i, SHAPES).items()}
        p, s = opt.update(g, s, p)
        s2 = opt.update_(g, s2, q)
    for k in SHAPES:
        assert torch.equal(p[k], q[k]) and torch.equal(s.nu[k], s2.nu[k])
    assert int(s2.step) == 3


def test_cosine_schedule_matches_reference():
    steps = np.arange(0, 14, dtype=np.int32)
    want = np.asarray(jax.vmap(joptim.cosine_schedule(3e-4, 4, 12,
                                                      floor=1e-5))(steps))
    got = optim.cosine_schedule(3e-4, 4, 12, floor=1e-5)(
        torch.from_numpy(steps))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_adam_promotes_bf16_params_as_the_reference_does(grad_dtype):
    """The reference's bias corrections are float32 arrays, so a bfloat16
    parameter comes out of one update float32; the moments keep the
    gradient's promotion (float32 accumulators give float32 moments)."""
    params = {"w": np.linspace(-1, 1, 6).astype(np.float32)}
    jp = {"w": jnp.asarray(params["w"], jnp.bfloat16)}
    jg = {"w": jnp.full((6,), 0.5, getattr(jnp, grad_dtype))}
    p = {"w": torch.from_numpy(params["w"]).to(torch.bfloat16)}
    g = {"w": torch.full((6,), 0.5, dtype=getattr(torch, grad_dtype))}
    jopt, opt = joptim.Adam(lr=0.01), optim.Adam(lr=0.01)
    jnew, js = jopt.update(jg, jopt.init(jp), jp)
    new, s = opt.update(g, opt.init(p), p)
    assert str(jnew["w"].dtype) == str(new["w"].dtype).split(".")[-1]
    assert str(js.mu["w"].dtype) == str(s.mu["w"].dtype).split(".")[-1]
    np.testing.assert_allclose(new["w"].numpy(), np.asarray(jnew["w"]),
                               atol=1e-6)
