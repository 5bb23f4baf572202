"""The port's dense LM decode step against the JAX package, on the CPU.

The JAX package's ``lm.init_params`` draws the weights; ``params_from_jax``
carries them across.  Both packages then decode the same tokens (numpy,
from a seed) in float32, as the reference's own serving tests run.
Tolerance: atol 1e-4 and rtol 1e-4 on logits and cache contents; the
two differ only in the order of float32 sums.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.models import common, lm

DENSE = ["qwen1p5_0p5b", "qwen2p5_3b", "qwen3_32b", "starcoder2_3b"]
STEPS = 12


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _jax_tree(cfg):
    params = jlm.init_params(jax.random.PRNGKey(0), cfg)
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("arch", DENSE)
def test_configs_are_the_references(arch):
    assert (dataclasses.asdict(configs.get(arch))
            == dataclasses.asdict(jconfigs.get(arch)))
    assert (dataclasses.asdict(configs.get_smoke(arch))
            == dataclasses.asdict(jconfigs.get_smoke(arch)))


@pytest.mark.parametrize("arch", ["mamba2_130m", "phi3p5_moe_42b",
                                  "whisper_small", "no_such_arch"])
def test_other_architectures_raise(arch):
    """The configs beyond the dense family are the reference's (the LM
    still refuses their families, below); an unknown id raises."""
    if arch == "no_such_arch":
        with pytest.raises(ValueError, match="unknown architecture"):
            configs.get(arch)
        with pytest.raises(ValueError, match="unknown architecture"):
            configs.get_smoke(arch)
        return
    assert (dataclasses.asdict(configs.get(arch))
            == dataclasses.asdict(jconfigs.get(arch)))
    assert (dataclasses.asdict(configs.get_smoke(arch))
            == dataclasses.asdict(jconfigs.get_smoke(arch)))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        lm.LM(configs.get_smoke(arch), device="meta")


def test_other_families_raise_not_ported():
    cfg = dataclasses.replace(configs.get_smoke("qwen2p5_3b"), family="moe")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        lm.LM(cfg, device="meta")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        lm.init_cache(cfg, 1, 4)


# qwen1.5 (G = 1), qwen2.5 (G = 2), qwen3 (qk_norm, head_dim 16) and
# starcoder2 (GELU MLP, no QKV bias).
@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match_reference(arch):
    cfg = _f32(configs.get_smoke(arch))
    jcfg = _f32(jconfigs.get_smoke(arch))
    jparams, tree = _jax_tree(jcfg)
    model = lm.params_from_jax(tree, cfg)
    B, max_len = 2, 16
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                               (STEPS, B))
    jcache = jlm.init_cache(jcfg, B, max_len)
    cache = lm.init_cache(cfg, B, max_len)
    jstep = jax.jit(jlm.decode_step, static_argnums=1)
    for t in range(STEPS):
        jlogits, jcache = jstep(jparams, jcfg, jcache,
                                jnp.asarray(tokens[t], jnp.int32))
        logits, cache = lm.decode_step(model, cfg, cache,
                                       torch.from_numpy(tokens[t]))
        assert cache.pos == t + 1 == int(jcache.pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4,
                                   err_msg=f"logits at step {t}")
    for got, want in ((cache.attn_k, jcache.attn_k),
                      (cache.attn_v, jcache.attn_v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def test_serve_step_is_greedy_argmax():
    cfg = _f32(configs.get_smoke("qwen2p5_3b"))
    gen = torch.Generator().manual_seed(0)
    model = lm.init_params(cfg, gen)
    token = torch.tensor([3, 7])
    logits, _ = lm.decode_step(model, cfg, lm.init_cache(cfg, 2, 4), token)
    nxt, cache = lm.serve_step(model, lm.init_cache(cfg, 2, 4), token, cfg)
    assert torch.equal(nxt, torch.argmax(logits, dim=-1))
    assert cache.pos == 1


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cache_takes_the_compute_dtype(compute_dtype):
    """The decode step's q is in ``compute_dtype``; the cache must be too,
    since the kernel takes k and v only in q's dtype."""
    cfg = dataclasses.replace(configs.get_smoke("qwen2p5_3b"),
                              compute_dtype=compute_dtype)
    cache = lm.init_cache(cfg, 2, 4)
    assert cache.attn_k.dtype == cache.attn_v.dtype == getattr(
        torch, compute_dtype)


def test_decode_step_raises_on_a_full_cache():
    cfg = _f32(configs.get_smoke("qwen1p5_0p5b"))
    model = lm.init_params(cfg, torch.Generator().manual_seed(0))
    cache = lm.init_cache(cfg, 1, 2)
    token = torch.tensor([1])
    for _ in range(2):
        _, cache = lm.decode_step(model, cfg, cache, token)
    with pytest.raises(ValueError, match="cache full"):
        lm.decode_step(model, cfg, cache, token)


def test_rope_and_rms_norm_match_reference():
    from repro.models import common as jcommon

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 5)).astype(np.int32)
    gamma = rng.standard_normal(16).astype(np.float32)
    tables = common.rope_tables(torch.from_numpy(pos), x.shape[-1])
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), *tables).numpy(),
        np.asarray(jcommon.rope(x, pos)), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma)).numpy(),
        np.asarray(jcommon.rms_norm(x, gamma)), atol=1e-5, rtol=1e-5)


def test_full_size_parameter_shapes_match_reference():
    """qwen2.5-3b at full width, built on the meta device: every parameter
    has the shape of the reference's leaf (less its leading L axis)."""
    cfg = configs.get("qwen2p5_3b")
    model = lm.LM(cfg, device="meta")
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, jconfigs.get(
        "qwen2p5_3b")), jax.random.PRNGKey(0))
    seen = set()
    for name, p in model.named_parameters():
        path, layer = lm.jax_name(name)
        leaf = shapes
        for key in path:
            leaf = leaf[key]
        want = leaf.shape[1:] if layer is not None else leaf.shape
        assert tuple(p.shape) == tuple(want), name
        if layer is not None:
            assert leaf.shape[0] == cfg.num_layers
        seen.add(path)
    assert seen == {tuple(getattr(k, "key", k) for k in kp)
                    for kp, _ in jax.tree_util.tree_leaves_with_path(shapes)}
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


def test_params_from_jax_rejects_a_wrong_tree():
    cfg = _f32(configs.get_smoke("qwen2p5_3b"))
    _, tree = _jax_tree(_f32(jconfigs.get_smoke("qwen2p5_3b")))
    del tree["blocks"]["attn"]["bq"]
    with pytest.raises(ValueError, match="missing"):
        lm.params_from_jax(tree, cfg)
    _, tree = _jax_tree(_f32(jconfigs.get_smoke("qwen2p5_3b")))
    tree["blocks"]["ln1"] = tree["blocks"]["ln1"][:1]
    with pytest.raises(ValueError, match="layers"):
        lm.params_from_jax(tree, cfg)


def test_params_are_cast_to_compute_dtype_and_norms_stay_f32():
    cfg = configs.get_smoke("qwen3_32b")            # bfloat16 compute
    _, tree = _jax_tree(jconfigs.get_smoke("qwen3_32b"))
    model = lm.params_from_jax(tree, cfg)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        want = (torch.float32 if leaf in common.NORM_PARAMS
                else torch.bfloat16)
        assert p.dtype == want, name
    np.testing.assert_array_equal(
        model.blocks[1].attn.wq.float().numpy(),
        np.asarray(jnp.asarray(tree["blocks"]["attn"]["wq"][1],
                               jnp.bfloat16).astype(jnp.float32)))
