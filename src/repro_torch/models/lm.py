"""The dense LM family in PyTorch: parameters, KV cache, decode and serve
steps.

The counterpart of the JAX package's ``models/lm.py`` for the dense family
(qwen1.5-0.5b, qwen2.5-3b, qwen3-32b, starcoder2-3b): GQA transformer
blocks with RoPE, optional QKV bias and qk-norm, and a SwiGLU or GELU MLP.
Every decode attention runs through the flash-decode kernel on the card
(:func:`repro_torch.models.common.decode_attention_step`).

The model is an ``nn.Module`` (:class:`LM`): ``embed`` and a list of
``blocks``, one per layer, where the reference stacks each parameter on a
leading L axis and scans over it; here a Python loop walks the blocks.
Parameter names follow the reference's tree (``blocks.3.attn.wq`` is
``params["blocks"]["attn"]["wq"][3]``), and :func:`params_from_jax`
carries a reference tree across.

The MoE, SSM, hybrid, audio and VLM families, and the forward, loss and
train steps, are not ported yet: :class:`LM` raises on another family
(:func:`check_family`).
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.models import common


def check_family(cfg):
    """Raise ``NotImplementedError`` unless ``cfg`` is of the dense family."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet in the "
            "PyTorch port: only the dense family is")


class Block(nn.Module):
    """One dense block: ln1, attn, ln2, mlp."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = common.param((cfg.d_model,), torch.float32, device)
        self.attn = common.Attention(cfg, device)
        self.ln2 = common.param((cfg.d_model,), torch.float32, device)
        self.mlp = common.MLP(cfg, device)


class LM(nn.Module):
    """A dense decoder-only LM with uninitialized parameters (use
    :func:`init_params` or :func:`params_from_jax`).  ``device="meta"``
    builds it without memory, for shapes."""

    def __init__(self, cfg, device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        self.embed = common.Embed(cfg, device)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.num_layers))


def init_params(cfg, generator: torch.Generator, device="cpu") -> LM:
    """A freshly initialized model, as the reference initializes one:
    normal(0, 0.02) matrices and embeddings, zero biases, unit norm gains.

    ``generator`` must live on ``device``.  The draws are made in float32
    and cast to the parameter's type, so a bfloat16 model is its float32
    twin (same seed) rounded.
    """
    model = LM(cfg, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in common.NORM_PARAMS:
                p.fill_(1.0)
            elif leaf in common.BIAS_PARAMS:
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=device) * 0.02)
    return model


def jax_name(name: str):
    """Where the port's parameter ``name`` lives in the reference tree:
    (path of keys, layer index or None)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return ("blocks", *parts[2:]), int(parts[1])
    return tuple(parts), None


def params_from_jax(tree: Mapping[str, Any], cfg, device="cpu") -> LM:
    """A model holding the reference's params: the tree of
    ``repro.models.lm.init_params`` as numpy arrays, ``{"embed": {tok,
    norm_f, unembed}, "blocks": {ln1, attn: {wq, wk, wv, wo, bq?, bk?,
    bv?, q_norm?, k_norm?}, ln2, mlp: {...}}}`` with every block leaf
    stacked on a leading L axis.  Values are cast to each parameter's
    type (``compute_dtype`` for matrices, float32 for norm gains)."""
    model = LM(cfg, device)
    names = {jax_name(n)[0] for n, _ in model.named_parameters()}

    def leaves(node, path=()):
        if isinstance(node, Mapping):
            for key, sub in node.items():
                yield from leaves(sub, path + (key,))
        else:
            yield path

    given = set(leaves(tree))
    if given != names:
        raise ValueError(f"param tree mismatch: missing "
                         f"{sorted(names - given)}, unexpected "
                         f"{sorted(given - names)}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            path, layer = jax_name(name)
            val = tree
            for key in path:
                val = val[key]
            val = np.asarray(val)
            if layer is not None:
                if val.shape[0] != cfg.num_layers:
                    raise ValueError(f"{'/'.join(path)}: {val.shape[0]} "
                                     f"layers, expected {cfg.num_layers}")
                val = val[layer]
            if val.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {val.shape}, expected "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(val, np.float32)))  # writable
    return model


class Cache(NamedTuple):
    """Decode state of the dense family.

    attn_k/attn_v: (L, B, Tmax, Kv, hd), written in place by each step;
    pos: the next position, a host int, so no step reads it back from the
    device.
    """

    attn_k: torch.Tensor
    attn_v: torch.Tensor
    pos: int = 0


def init_cache(cfg, batch: int, max_len: int, device="cpu") -> Cache:
    """A zeroed cache in ``cfg.compute_dtype``, the dtype of every q the
    decode step makes (the kernel takes k and v only in q's dtype)."""
    check_family(cfg)
    dt = common.dtype(cfg.compute_dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd())
    return Cache(attn_k=torch.zeros(shape, dtype=dt, device=device),
                 attn_v=torch.zeros(shape, dtype=dt, device=device), pos=0)


@torch.no_grad()
def decode_step(params: LM, cfg, cache: Cache, token):
    """One decode step.  token: (B,) int -> (logits (B, V), cache with
    pos + 1).  The cache's tensors are updated in place."""
    check_family(cfg)
    pos = cache.pos
    if pos >= cache.attn_k.shape[2]:
        raise ValueError(f"cache full: position {pos} of "
                         f"{cache.attn_k.shape[2]}")
    B = token.shape[0]
    x = common.embed(params.embed, cfg, token[:, None])
    cos_sin = common.rope_tables(torch.full((B, 1), pos, device=x.device),
                                 cfg.hd(), cfg.rope_theta)
    for layer, p in enumerate(params.blocks):
        hn = common.rms_norm(x, p.ln1, cfg.norm_eps)
        out = common.decode_attention_step(
            p.attn, cfg, hn, cache.attn_k[layer], cache.attn_v[layer], pos,
            cos_sin=cos_sin)
        x = x + out
        x = x + common.mlp(p.mlp, cfg, common.rms_norm(x, p.ln2,
                                                        cfg.norm_eps))
    logits = common.unembed(params.embed, cfg, x)
    return logits[:, 0, :], cache._replace(pos=pos + 1)


def serve_step(params: LM, cache: Cache, token, cfg):
    """One batched greedy decode step: (B,) token ids -> (B,) next ids."""
    logits, cache = decode_step(params, cfg, cache, token)
    return torch.argmax(logits, dim=-1), cache
