"""The port's mixture-of-experts FFN against the JAX package, on the CPU.

The same numpy inputs (from a seed) go through ``repro.models.moe.moe_ffn``
and ``repro_torch.models.moe.moe_ffn`` in float32.  Tolerance: atol and
rtol 1e-5 on the outputs (the two differ only in the order of float32
sums); the kept (token, choice) masks and the chosen experts must be
equal exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import moe

TOL = dict(atol=1e-5, rtol=1e-5)


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32", **kw)


# phi3.5-moe smoke (top-2 of 4, SwiGLU), qwen3-moe smoke (top-2 of 8) and
# phi's smoke with a GELU MLP (no w_gate).
CONFIGS = {
    "phi": lambda cf: _f32(configs.get_smoke("phi3p5_moe_42b"),
                           moe_capacity_factor=cf),
    "qwen3": lambda cf: _f32(configs.get_smoke("qwen3_moe_235b"),
                             moe_capacity_factor=cf),
    "gelu": lambda cf: _f32(configs.get_smoke("phi3p5_moe_42b"),
                            mlp_act="gelu", moe_capacity_factor=cf),
}


def _params(cfg, seed=0):
    """The reference's tree of ``init_moe``'s shapes, drawn with numpy,
    and the port's module holding the same values."""
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    shapes = {"router": (d, E), "w_up": (E, d, f), "w_down": (E, f, d)}
    if cfg.mlp_act == "swiglu":
        shapes["w_gate"] = (E, d, f)
    rng = np.random.default_rng(seed)
    tree = {k: (0.02 * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}
    p = moe.MoE(cfg)
    assert {n for n, _ in p.named_parameters()} == set(tree)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(tree[name])))
    return tree, p


@functools.partial(jax.jit, static_argnums=(1, 3))
def _reference(tree, cfg, x, n_groups):
    """The reference's output, and its top-k choices and kept mask by its
    own steps (``repro/models/moe.py``) as (N, k) arrays."""
    B, T, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    g = B * T // n_groups
    logits = (x.reshape(n_groups, g, D) @ tree["router"]).astype(jnp.float32)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat = jax.nn.one_hot(top_e, E, dtype=jnp.int32).reshape(n_groups,
                                                              g * k, E)
    pos = ((jnp.cumsum(flat, axis=1) - flat) * flat).sum(-1)
    keep = pos.reshape(n_groups, g, k) < jmoe.capacity(g, cfg)
    return (jmoe.moe_ffn(tree, cfg, x, n_groups=n_groups),
            top_e.reshape(-1, k), keep.reshape(-1, k))


def _compare(tree, p, cfg, x, n_groups):
    want, top_e, keep = map(np.asarray, _reference(tree, cfg, jnp.asarray(x),
                                                   n_groups))
    got = moe.moe_ffn(p, cfg, torch.from_numpy(x), n_groups=n_groups)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    r = moe.route(p, cfg, torch.from_numpy(x), n_groups)
    np.testing.assert_array_equal(r.experts.numpy(), top_e)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert not r.weight[~r.keep].any()
    return r


@pytest.mark.parametrize("g", [1, 3, 8])
@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_moe_ffn_matches_reference(name, cf, g):
    cfg = CONFIGS[name](cf)
    tree, p = _params(cfg)
    x = np.random.default_rng(g).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    _compare(tree, p, cfg, x, n_groups=24 // g)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_expert_router_drops_past_capacity(name):
    """Every token's best expert is 0, and the others tie at logit 0, so
    the second choice is expert 1 (the lower index) for all: each group
    of 8 keeps C = capacity(8) choices per expert and drops the rest."""
    cfg = CONFIGS[name](1.25)
    tree, p = _params(cfg)
    router = np.zeros_like(tree["router"])
    router[:, 0] = 1.0
    tree["router"] = router
    with torch.no_grad():
        p.router.copy_(torch.from_numpy(router))
    x = np.abs(np.random.default_rng(1).standard_normal(
        (2, 8, cfg.d_model))).astype(np.float32)
    r = _compare(tree, p, cfg, x, n_groups=2)
    C = moe.capacity(8, cfg)
    assert C < 8
    assert (r.experts[:, 0] == 0).all() and (r.experts[:, 1] == 1).all()
    keep = r.keep.reshape(2, 8, -1)
    assert (keep[:, :C].all() and not keep[:, C:].any())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tied_router_logits_keep_lower_expert_first(name):
    """Inputs and router of small multiples of 1/4 and 1/8, the router
    zero past its first two rows: every logit is exact in float32 whatever
    the order of the sums, and many tie, as a bfloat16 model's rounded
    logits do."""
    cfg = CONFIGS[name](1.25)
    tree, p = _params(cfg)
    rng = np.random.default_rng(2)
    router = np.zeros_like(tree["router"])
    router[:2] = rng.integers(-1, 2, router[:2].shape) / 8
    tree["router"] = router
    with torch.no_grad():
        p.router.copy_(torch.from_numpy(router))
    x = (rng.integers(-2, 3, (3, 8, cfg.d_model)) / 4).astype(np.float32)
    logits = x.reshape(-1, cfg.d_model) @ router
    srt = np.sort(logits, axis=-1)[:, ::-1]
    k = cfg.experts_per_token
    assert (srt[:, k - 1] == srt[:, k]).any()     # a tie at the cut
    _compare(tree, p, cfg, x, n_groups=3)


@pytest.mark.parametrize("arch", ["phi3p5_moe_42b", "qwen3_moe_235b"])
def test_capacity_is_the_references(arch):
    for cf in (1.0, 1.25, 2.0, 8.0):
        cfg = dataclasses.replace(configs.get(arch), moe_capacity_factor=cf)
        jcfg = dataclasses.replace(jconfigs.get(arch),
                                   moe_capacity_factor=cf)
        for g in (1, 2, 3, 7, 8, 64, 512, 1000):
            assert moe.capacity(g, cfg) == jmoe.capacity(g, jcfg)
    assert moe.group_count(24, 5) == 4 and moe.group_count(1024) == 2
    # Decode groups the B tokens of a step together: at B = 8,
    # phi3.5-MoE keeps 2 choices per expert.
    assert moe.capacity(8, configs.get("phi3p5_moe_42b")) == 2
