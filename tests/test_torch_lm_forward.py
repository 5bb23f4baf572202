"""The port's full-sequence LM forward against the JAX package, on the CPU.

The weights are the reference tree drawn with numpy
(``test_torch_lm.reference_tree``), carried across with
``lm.params_from_jax``; tokens and frontend features are numpy draws from
a seed.  Everything runs in float32 at the smoke configs.  Tolerances:
atol / rtol 1e-4 on logits (forward and prefill), atol 1e-5 on the mean
loss; only the order of float32 sums differs.  The reference runs jitted
(one compile a config for its forward, prefill and loss together), its
own way of running.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.models import common, lm, moe, ssm
from test_torch_lm import _f32, reference_tree

TOL = dict(atol=1e-4, rtol=1e-4)
B, T = 2, 16


def _aux(cfg, seed=6):
    """Seeded frontend features of an audio / vlm config, else None."""
    if not lm.cross_sites(cfg):
        return None
    S = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_seq
    feats = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return {"frames" if cfg.family == "audio" else "patches": feats}


def _inputs(cfg, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _torch(a):
    return None if a is None else {k: torch.from_numpy(v)
                                   for k, v in a.items()}


def _jax(a):
    return None if a is None else {k: jnp.asarray(v) for k, v in a.items()}


# All ten configs: dense (G = 1 and 2, qk_norm, GELU), MoE (top-2 of 4 and
# of 8), SSM (two SSD chunks of 8), hybrid (groups and a tail), audio
# (encoder over 32 frames, cross-attention each layer), vlm (groups with a
# cross layer over 16 patches).
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_forward_prefill_and_loss_match_reference(arch):
    cfg = _f32(configs.get_smoke(arch))
    jcfg = _f32(jconfigs.get_smoke(arch))
    tree = reference_tree(jcfg)
    model = lm.params_from_jax(tree, cfg)
    tokens, labels = _inputs(cfg)
    aux = _aux(cfg)

    @jax.jit
    def ref(params, tokens, labels, aux):
        return (jlm.forward(params, jcfg, tokens, aux, remat=False),
                jlm.prefill(params, jcfg, tokens, aux, remat=False),
                jlm.lm_loss(params, jcfg, tokens, labels, aux))

    jlogits, jlast, jloss = ref(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(tokens), jnp.asarray(labels),
                                _jax(aux))
    toks = torch.from_numpy(tokens).long()
    with torch.no_grad():
        logits = lm.forward(model, cfg, toks, _torch(aux), remat=False)
        loss = lm.lm_loss(model, cfg, toks, torch.from_numpy(labels).long(),
                          _torch(aux))
    last = lm.prefill(model, cfg, toks, _torch(aux))
    assert logits.shape == (B, T, cfg.vocab_size)
    assert last.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_prefill_matches_teacher_forced_decode(arch):
    """A prefill's logits equal the last logits of decode steps fed the
    same prompt (MoE at capacity factor 8, where neither path drops a
    token, as the reference's own decode-against-forward test sets it)."""
    cfg = configs.get_smoke(arch)
    cfg = _f32(dataclasses.replace(cfg, moe_capacity_factor=8.0)
               if cfg.family == "moe" else cfg)
    model = lm.init_params(cfg, torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(_inputs(cfg)[0]).long()
    aux = _torch(_aux(cfg))
    last = lm.prefill(model, cfg, tokens, aux)
    cache = lm.init_cache(cfg, B, T)
    if aux is not None:
        with torch.no_grad():
            feats = (lm._encode_audio(model, cfg, aux["frames"])
                     if cfg.family == "audio" else aux["patches"])
        k, v = lm.precompute_cross_kv(model, cfg, feats)
        cache = cache._replace(cross_k=k, cross_v=v)
    for t in range(T):
        logits, cache = lm.decode_step(model, cfg, cache, tokens[:, t])
    np.testing.assert_allclose(last.numpy(), logits.numpy(), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_matches_direct_and_reference(causal):
    """A ragged tail (37 keys in chunks of 8: the last holds 5, 3 masked)
    and GQA with G = 2: the online softmax equals the whole score matrix's
    and the reference's blockwise recurrence."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 37, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 37, 2, 8)).astype(np.float32)
            for _ in range(2))
    got = common.blockwise_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal, kv_chunk=8)
    direct = common._direct_attention(*map(torch.from_numpy, (q, k, v)),
                                      torch.float32, causal)
    want = jcommon.blockwise_attention(q, k, v, causal=causal, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3_32b", "whisper_small"])
def test_attention_past_the_threshold_matches_reference(arch, monkeypatch):
    """``attention`` and ``cross_attention`` take the blockwise path past
    FLASH_THRESHOLD queries (lowered to 8 in both packages here): qk_norm
    (qwen3) and 32 encoder frames (whisper)."""
    monkeypatch.setattr(common, "FLASH_THRESHOLD", 8)
    monkeypatch.setattr(jcommon, "FLASH_THRESHOLD", 8)
    cfg = _f32(configs.get_smoke(arch))
    tree = reference_tree(_f32(jconfigs.get_smoke(arch)))
    model = lm.params_from_jax(tree, cfg)
    blk, jblk = (model.cross[0], tree["cross"]) if cfg.family == "audio" \
        else (model.blocks[0], tree["blocks"])
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), jblk)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    with torch.no_grad():
        if cfg.family == "audio":
            feats = rng.standard_normal((B, 32, cfg.d_model)).astype(
                np.float32)
            got = common.cross_attention(blk.xattn, cfg, torch.from_numpy(x),
                                         torch.from_numpy(feats))
            want = jax.jit(lambda p, x, f: jcommon.cross_attention(
                p, cfg, x, f))(jp["xattn"], x, feats)
        else:
            got = common.attention(blk.attn, cfg, torch.from_numpy(x),
                                   torch.from_numpy(pos.copy()))
            want = jax.jit(lambda p, x, pos: jcommon.attention(
                p, cfg, x, pos))(jp["attn"], x, pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_reference_at_each_chunk(chunk):
    """T = 48: chunks of 8 and 16 divide it; 64 is lowered to 48 (one
    chunk).  Each matches the reference at the same chunk and the port at
    chunk 8 (the chunking moves only float32 rounding)."""
    rng = np.random.default_rng(3)
    Bn, Tn, H, P, S = 2, 48, 3, 4, 5
    x = rng.standard_normal((Bn, Tn, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (Bn, Tn, H)).astype(np.float32)
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    Bm, Cm = (rng.standard_normal((Bn, Tn, S)).astype(np.float32)
              for _ in range(2))
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    got = ssm.ssd_chunked(*args, chunk)
    want = jax.jit(jssm.ssd_chunked, static_argnums=5)(x, dt, A, Bm, Cm,
                                                       chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(),
                               ssm.ssd_chunked(*args, 8).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_aux_load_balance_loss_matches_reference():
    """Value and the router's gradient (qwen3-MoE smoke: top-2 of 8)."""
    cfg = _f32(configs.get_smoke("qwen3_moe_235b"))
    rng = np.random.default_rng(4)
    router = (0.3 * rng.standard_normal((cfg.d_model, cfg.num_experts))
              ).astype(np.float32)
    x = rng.standard_normal((3, 10, cfg.d_model)).astype(np.float32)
    p = moe.MoE(cfg)
    with torch.no_grad():
        p.router.copy_(torch.from_numpy(router))
    p.router.requires_grad_(True)
    loss = moe.aux_load_balance_loss(p, cfg, torch.from_numpy(x))
    (grad,) = torch.autograd.grad(loss, [p.router])
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda r: jmoe.aux_load_balance_loss({"router": r}, cfg, x)))(router)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-6,
                               rtol=1e-5)
