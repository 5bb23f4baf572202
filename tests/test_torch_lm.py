"""The port's LM decode step against the JAX package, on the CPU.

The weights are drawn with numpy in the tree of the JAX package's
``lm.init_params`` (:func:`reference_tree`); ``params_from_jax`` carries
them across.  Both packages then decode the same tokens (numpy,
from a seed) in float32, as the reference's own serving tests run; audio
and vlm models attend to the same seeded random frontend features,
projected by each package's ``precompute_cross_kv``.  Tolerance: atol
1e-4 and rtol 1e-4 on logits and every cache leaf (attention, cross and
Mamba caches); the two differ only in the order of float32 sums.
"""
import dataclasses
import functools

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
TOL = dict(atol=1e-4, rtol=1e-4)


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


ONES = ("ln1", "ln2", "norm_f", "q_norm", "k_norm", "enc_norm", "gate_norm",
        "D")
ZEROS = ("bq", "bk", "bv", "conv_b")


def reference_tree(cfg, seed=0):
    """The reference's parameter tree for ``cfg`` (its structure and shapes
    from ``jax.eval_shape`` of ``repro.models.lm.init_params``), drawn with
    numpy as that init draws: normal(0, 0.02), conv_w normal(0, 0.5),
    norm gains and D ones, biases zeros, A_log and dt_bias its fixed
    values.  Drawing with numpy spares compiling the reference's init."""
    shapes = jax.eval_shape(functools.partial(jlm.init_params, cfg=cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", path[-1])
        if name in ONES:
            val = np.ones(s.shape)
        elif name in ZEROS:
            val = np.zeros(s.shape)
        elif name == "A_log":
            val = np.broadcast_to(np.log(np.linspace(1.0, 16.0, s.shape[-1])),
                                  s.shape)
        elif name == "dt_bias":
            val = np.full(s.shape, np.log(np.expm1(0.01)))
        else:
            scale = 0.5 if name == "conv_w" else 0.02
            val = scale * rng.standard_normal(s.shape)
        return np.array(val, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_tree(cfg):
    tree = reference_tree(cfg)
    return jax.tree.map(jnp.asarray, tree), tree


def _cross_feats(cfg, B, seed=6):
    """Seeded random frontend features (B, S, d) of an audio / vlm config
    (zeros would make every cross key equal and check nothing)."""
    S = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_seq
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _mamba_leaves(jcache, cfg):
    """The reference's Mamba caches as (conv, ssm) pairs, in the port's
    order: layer by layer; hybrid's groups, then its tail."""
    if cfg.family == "ssm":
        stacks = [jcache.mamba]
    else:
        stacks = [jcache.mamba["groups"], jcache.mamba["tail"]]
    out = []
    for mc in stacks:
        if mc is None:
            continue
        conv, ssm = np.asarray(mc.conv), np.asarray(mc.ssm)
        lead = conv.ndim - 3
        conv = conv.reshape((-1,) + conv.shape[lead:])
        ssm = ssm.reshape((-1,) + ssm.shape[lead:])
        out += list(zip(conv, ssm))
    return out


@pytest.mark.parametrize("arch", DENSE)
def test_configs_are_the_references(arch):
    assert (dataclasses.asdict(configs.get(arch))
            == dataclasses.asdict(jconfigs.get(arch)))
    assert (dataclasses.asdict(configs.get_smoke(arch))
            == dataclasses.asdict(jconfigs.get_smoke(arch)))


@pytest.mark.parametrize("arch", ["mamba2_130m", "phi3p5_moe_42b",
                                  "whisper_small", "no_such_arch"])
def test_other_architectures_raise(arch):
    """The configs beyond the dense family are the reference's and build
    at full width (on the meta device); only an unknown id raises."""
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
    model = lm.LM(configs.get(arch), device="meta")
    assert next(model.parameters()).is_meta


def test_other_families_raise_not_ported():
    """A family the reference does not know raises ``ValueError``, as the
    reference's ``init_params`` does."""
    cfg = dataclasses.replace(configs.get_smoke("qwen2p5_3b"),
                              family="rnn")
    with pytest.raises(ValueError, match="unknown family"):
        lm.LM(cfg, device="meta")
    with pytest.raises(ValueError, match="unknown family"):
        lm.init_cache(cfg, 1, 4)
    with pytest.raises(ValueError, match="unknown family"):
        jlm.init_params(jax.random.PRNGKey(0), dataclasses.replace(
            jconfigs.get_smoke("qwen2p5_3b"), family="rnn"))


# Dense: qwen1.5 (G = 1), qwen2.5 (G = 2), qwen3 (qk_norm, head_dim 16),
# starcoder2 (GELU MLP, no QKV bias); then MoE (phi3.5: top-2 of 4;
# qwen3-moe: top-2 of 8, qk_norm), SSM, hybrid (two groups of two Mamba
# layers with the shared block, and a tail of one), audio (self- and
# cross-attention each layer) and vlm (two groups of one self layer and a
# cross layer).
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
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
    if lm.cross_sites(cfg):
        feats = _cross_feats(cfg, B)
        jk, jv = jlm.precompute_cross_kv(jparams, jcfg, jnp.asarray(feats))
        jcache = jcache._replace(cross_k=jk, cross_v=jv)
        k, v = lm.precompute_cross_kv(model, cfg, torch.from_numpy(feats))
        cache = cache._replace(cross_k=k, cross_v=v)
    jstep = jax.jit(jlm.decode_step, static_argnums=1)
    for t in range(STEPS):
        jlogits, jcache = jstep(jparams, jcfg, jcache,
                                jnp.asarray(tokens[t], jnp.int32))
        logits, cache = lm.decode_step(model, cfg, cache,
                                       torch.from_numpy(tokens[t]))
        assert cache.pos == t + 1 == int(jcache.pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"logits at step {t}", **TOL)
    pairs = [(getattr(cache, f), getattr(jcache, f))
             for f in ("attn_k", "attn_v", "cross_k", "cross_v")]
    assert all((a is None) == (b is None) for a, b in pairs)
    mamba = _mamba_leaves(jcache, cfg) if cache.mamba else []
    assert len(mamba) == len(cache.mamba or ()) == lm.mamba_layers(cfg)
    for mc, (conv, ssm) in zip(cache.mamba or (), mamba):
        pairs += [(mc.conv, conv), (mc.ssm, ssm)]
    for got, want in pairs:
        if got is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
    """All ten architectures at full width, built on the meta device:
    every parameter has the shape of the reference's leaf less its
    leading stack axes, the port's names cover the reference's leaves,
    and the counts agree."""
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch)
        model = lm.LM(cfg, device="meta")
        shapes = jax.eval_shape(functools.partial(
            jlm.init_params, cfg=jconfigs.get(arch)), jax.random.PRNGKey(0))
        seen, count = set(), 0
        for name, p in model.named_parameters():
            path, idx = lm.jax_name(name)
            leaf = shapes
            for key in path:
                leaf = leaf[key]
            assert tuple(p.shape) == tuple(leaf.shape[len(idx):]), name
            assert all(0 <= i < n for i, n in zip(idx, leaf.shape)), name
            seen.add(path)
            count += p.numel()
        assert seen == {tuple(getattr(k, "key", k) for k in kp) for kp, _
                        in jax.tree_util.tree_leaves_with_path(shapes)}, arch
        assert count == sum(int(np.prod(s.shape))
                            for s in jax.tree.leaves(shapes)), arch


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
