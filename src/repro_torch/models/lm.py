"""The LM families in PyTorch: parameters, the full-sequence forward,
prefill, the chunked loss and train steps, decode caches, decode and
serve steps.

The counterpart of the JAX package's ``models/lm.py``, in all six
families of its configs:

  dense   -- GQA transformer blocks with RoPE, optional QKV bias and
             qk-norm, a SwiGLU or GELU MLP (qwen1.5-0.5b, qwen2.5-3b,
             qwen3-32b, starcoder2-3b)
  moe     -- the same attention with a top-k mixture-of-experts FFN
             (phi3.5-moe, qwen3-moe; :mod:`repro_torch.models.moe`)
  ssm     -- Mamba2 blocks (mamba2-130m; :mod:`repro_torch.models.ssm`)
  hybrid  -- groups of Mamba2 blocks, each followed by one *shared*
             attention block with a KV cache of its own per site, then a
             tail of Mamba2 blocks (zamba2-1.2b)
  audio   -- a bidirectional encoder over frame embeddings (the
             frontend is a stub, as in the reference), then self-attention
             blocks, each followed by a cross-attention block over the
             encoder's output (whisper-small; decode reads precomputed
             cross K/V and does not run the encoder)
  vlm     -- groups of self-attention blocks, each group followed by one
             cross-attention block over precomputed vision K/V
             (llama-3.2-vision)

Every self- and cross-attention of a decode step runs through the
flash-decode kernel on the card (:func:`common.decode_attention_step`,
:func:`common.cross_attention_step`).  The forward (:func:`forward_hidden`,
:func:`forward`, :func:`prefill`) and the training steps are plain tensor
operations, as the reference's are: no Pallas kernel lies on that path.
Stacks run layer by layer, each layer under
``torch.utils.checkpoint`` with ``remat`` (:func:`_run_stack`, the
counterpart of ``_scan_stack``'s ``jax.checkpoint``; ``"dots"`` keeps the
weight projections' outputs through selective checkpointing).

Sharded training threads a :class:`common.ShardingPolicy` (``pol=``)
through the forward, the loss and the train steps, as the reference
does: the parameters, moments and batch are DTensors placed by
``repro_torch.distributed.sharding`` and DTensor's sharding propagation
stands where XLA's partitioner stands in the reference.  Sharded serving
threads the decode-kind policy through :func:`decode_step` /
:func:`serve_step` the same way, over a cache placed by
``sharding.place_cache`` (the sequence on ``model``; the attention
combines the shards' flash-decode partials, ``common.py``).

The model is an ``nn.Module`` (:class:`LM`) whose stacks are
``nn.ModuleList`` s, where the reference stacks each parameter on leading
axes and scans over them.  Parameter names follow the reference's tree:
``blocks.3.attn.wq`` is ``params["blocks"]["attn"]["wq"][3]``,
``groups.2.3.mamba.in_proj`` is ``params["groups"]["mamba"]["in_proj"][2,
3]``, and ``shared_attn.attn.wq`` is unstacked (:func:`jax_name`);
:func:`params_from_jax` carries a reference tree across.

Training holds float32 master weights, as the reference's ``init_params``
makes every leaf float32 whatever the config: build the model with
``init_params(..., dtype=torch.float32)``; the forward casts each weight
to ``compute_dtype`` at its use (:func:`common.cast`).  The steps keep the
reference's functional signature, ``(params, opt_state, batch, cfg,
optimizer) -> (params, opt_state, loss)``, and update the model's tensors
and the moments in place (the counterpart of JAX's buffer donation), so a
step holds one copy of the weights.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Dict, List, Mapping, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import common, moe, ssm
from repro_torch.models.common import NO_SHARDING, ShardingPolicy

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
# Leading stack axes of each top-level list, as the reference stacks them.
STACK_AXES = {"blocks": 1, "encoder": 1, "cross": 1, "tail": 1, "groups": 2}
# Leaves the reference initializes to ones, beside the Mamba leaves of
# :func:`ssm.init_fixed`.
ONES = common.NORM_PARAMS + ("enc_norm",)


class Block(nn.Module):
    """One dense block: ln1, attn, ln2, mlp."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = common.param((cfg.d_model,), torch.float32, device)
        self.attn = common.Attention(cfg, device)
        self.ln2 = common.param((cfg.d_model,), torch.float32, device)
        self.mlp = common.MLP(cfg, device)


class MoEBlock(nn.Module):
    """One MoE block: ln1, attn, ln2, moe."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = common.param((cfg.d_model,), torch.float32, device)
        self.attn = common.Attention(cfg, device)
        self.ln2 = common.param((cfg.d_model,), torch.float32, device)
        self.moe = moe.MoE(cfg, device)


class MambaBlock(nn.Module):
    """One Mamba2 block: ln1, mamba."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = common.param((cfg.d_model,), torch.float32, device)
        self.mamba = ssm.Mamba(cfg, device)


class CrossBlock(nn.Module):
    """One cross-attention block: ln1, xattn, ln2, mlp."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = common.param((cfg.d_model,), torch.float32, device)
        self.xattn = common.Attention(cfg, device)
        self.ln2 = common.param((cfg.d_model,), torch.float32, device)
        self.mlp = common.MLP(cfg, device)


def _stack(n, block, cfg, device):
    return nn.ModuleList(block(cfg, device) for _ in range(n))


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


class LM(nn.Module):
    """A decoder LM of any family with uninitialized parameters (use
    :func:`init_params` or :func:`params_from_jax`).  ``device="meta"``
    builds it without memory, for shapes.  Matrices and embeddings are
    stored in ``dtype``, by default the config's ``compute_dtype``
    (:func:`common.stored`).  An unknown family raises ``ValueError``."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        cfg = common.stored(cfg, dtype)
        self.embed = common.Embed(cfg, device)
        fam, L = cfg.family, cfg.num_layers
        if fam in ("dense", "moe"):
            self.blocks = _stack(L, MoEBlock if fam == "moe" else Block, cfg,
                                 device)
        elif fam == "ssm":
            self.blocks = _stack(L, MambaBlock, cfg, device)
        elif fam == "hybrid":
            n_groups, rem = divmod(L, cfg.shared_attn_period)
            self.groups = nn.ModuleList(
                _stack(cfg.shared_attn_period, MambaBlock, cfg, device)
                for _ in range(n_groups))
            self.tail = _stack(rem, MambaBlock, cfg, device)
            self.shared_attn = Block(cfg, device)
        elif fam == "audio":
            self.encoder = _stack(cfg.encoder_layers, Block, cfg, device)
            self.enc_norm = common.param((cfg.d_model,), torch.float32,
                                         device)
            self.blocks = _stack(L, Block, cfg, device)
            self.cross = _stack(L, CrossBlock, cfg, device)
        else:                                               # vlm
            n_cross = L // cfg.cross_attn_period
            self.groups = nn.ModuleList(
                _stack(cfg.cross_attn_period - 1, Block, cfg, device)
                for _ in range(n_cross))
            self.cross = _stack(n_cross, CrossBlock, cfg, device)


def init_params(cfg, generator: torch.Generator, device="cpu",
                dtype=None) -> LM:
    """A freshly initialized model, as the reference initializes one:
    normal(0, 0.02) matrices and embeddings, normal(0, 0.5) Mamba conv
    weights, zero biases, unit norm gains, and the Mamba leaves the
    reference fixes (:func:`ssm.init_fixed`).

    ``generator`` must live on ``device``.  The draws are made in float32
    and cast to the parameter's type, so a bfloat16 model is its float32
    twin (same seed) rounded.  ``dtype=torch.float32`` stores the matrices
    in float32 (training's master weights; see :class:`LM`).
    """
    model = LM(cfg, device, dtype)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ONES:
                p.fill_(1.0)
            elif leaf in common.BIAS_PARAMS:
                p.zero_()
            elif not ssm.init_fixed(leaf, p):
                scale = 0.5 if leaf == "conv_w" else 0.02
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=device) * scale)
    return model


def jax_name(name: str):
    """Where the port's parameter ``name`` lives in the reference tree:
    (path of keys, index into the leaf's leading stack axes, () if it has
    none)."""
    parts = name.split(".")
    n = STACK_AXES.get(parts[0], 0)
    return ((parts[0], *parts[1 + n:]),
            tuple(int(i) for i in parts[1:1 + n]))


def params_from_jax(tree: Mapping[str, Any], cfg, device="cpu",
                    dtype=None) -> LM:
    """A model holding the reference's params: the tree of
    ``repro.models.lm.init_params`` as numpy arrays (``{"embed": {tok,
    norm_f, unembed?}, "blocks": {ln1, attn: {...}, ...}, ...}``, each
    stacked leaf with its layer axes in front).  Values are cast to each
    parameter's type (``compute_dtype`` for matrices, float32 for norm
    gains and the Mamba scalars; ``dtype`` as for :class:`LM`)."""
    model = LM(cfg, device, dtype)
    where = {n: jax_name(n) for n, _ in model.named_parameters()}
    names = {path for path, _ in where.values()}
    stacks = {}                  # path -> the leading shape its leaf needs
    for path, idx in where.values():
        if idx:
            old = stacks.get(path, (0,) * len(idx))
            stacks[path] = tuple(max(a, i + 1) for a, i in zip(old, idx))

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
            path, idx = where[name]
            val = tree
            for key in path:
                val = val[key]
            val = np.asarray(val)
            if idx:
                if val.shape[:len(idx)] != stacks[path]:
                    raise ValueError(f"{'/'.join(path)}: "
                                     f"{val.shape[:len(idx)]} layers, "
                                     f"expected {stacks[path]}")
                val = val[idx]
            if val.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {val.shape}, expected "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(val, np.float32)))  # writable
    return model


# ---------------------------------------------------------------------------
# Forward (training / prefill).
# ---------------------------------------------------------------------------
def _norm(x, g, cfg, pol):
    return common.rms_norm(x, pol.weight(g), cfg.norm_eps)


def _attn_block(p, cfg, x, cos_sin, *, causal=True, moe_groups=None,
                pol=NO_SHARDING):
    """A dense or MoE block over the whole sequence."""
    x = x + common.attention(p.attn, cfg, _norm(x, p.ln1, cfg, pol), None,
                             causal=causal, cos_sin=cos_sin, pol=pol)
    z = _norm(x, p.ln2, cfg, pol)
    if isinstance(p, MoEBlock):
        return x + moe.moe_ffn(p.moe, cfg, z, n_groups=moe_groups, pol=pol)
    return x + common.mlp(p.mlp, cfg, z, pol=pol)


def _mamba_block(p, cfg, x, pol=NO_SHARDING):
    return x + ssm.mamba_forward(p.mamba, cfg, _norm(x, p.ln1, cfg, pol),
                                 pol=pol)


def _cross_block(p, cfg, x, feats, pol=NO_SHARDING):
    x = x + common.cross_attention(p.xattn, cfg, _norm(x, p.ln1, cfg, pol),
                                   feats, pol=pol)
    return x + common.mlp(p.mlp, cfg, _norm(x, p.ln2, cfg, pol), pol=pol)


REMATS = (True, False, "full", "none", "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: save the
    output of a product with no batch dims -- a weight projection ``x @
    W`` (:func:`common._dense`, the router's), which marks itself
    (``common.projection``) -- and recompute the rest, the products with
    batch dims among them: attention's scores and P.V, the SSD
    einsums, and the MoE experts' products, which carry E as a batch dim
    in the reference even though the port runs them as one ``mm`` a
    routed expert (so the policy reads the mark, not the op's name)."""
    if common.in_projection() and op in _PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _run_stack(layers, body, x, remat=True):
    """x through ``body(layer, x)`` for each layer in turn.

    remat: True / "full" recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant: only each layer's input is
    kept); "dots" keeps the outputs of the weight projections and
    recomputes the rest (selective checkpointing under
    :func:`_dots_policy`, the reference's
    ``dots_with_no_batch_dims_saveable``); False / "none" keeps every
    activation.  Without autograd there is nothing to keep and the layers
    simply run.
    """
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r}")
    if not torch.is_grad_enabled() or remat in (False, "none"):
        for layer in layers:
            x = body(layer, x)
        return x
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    for layer in layers:
        x = checkpoint(body, layer, x, use_reentrant=False, **kw)
    return x


def _positions(B, T, device):
    return torch.arange(T, device=device).expand(B, T)


def _encode_audio(params: LM, cfg, frames, *, remat=True, pol=NO_SHARDING):
    """The whisper encoder over frame embeddings (B, S, D) (the frontend
    stub): bidirectional attention blocks with RoPE, then ``enc_norm``."""
    B, S, _ = frames.shape
    x = frames.to(common.dtype(cfg.compute_dtype))
    cos_sin = common.rope_tables(_positions(B, S, x.device), cfg.hd(),
                                 cfg.rope_theta)
    x = _run_stack(params.encoder, lambda lp, h: _attn_block(
        lp, cfg, h, cos_sin, causal=False, pol=pol), x, remat)
    return _norm(x, params.enc_norm, cfg, pol)


def forward_hidden(params: LM, cfg, tokens,
                   aux: Optional[Dict[str, torch.Tensor]] = None, *,
                   remat=True, moe_groups=None, pol=NO_SHARDING):
    """The causal LM trunk: tokens (B, T) -> final hidden states (B, T, D)
    in ``compute_dtype``.

    ``aux`` carries the frontend stubs: {"frames": (B, S, D)} for audio,
    {"patches": (B, S, D)} for vlm.  Hybrid's and vlm's outer group
    stacks are not rematerialized, as in the reference; the layers inside
    them are.
    """
    _check_family(cfg)
    B, T = tokens.shape
    x = common.embed(params.embed, cfg, tokens, pol=pol)
    cos_sin = (common.rope_tables(_positions(B, T, x.device), cfg.hd(),
                                  cfg.rope_theta)
               if attention_sites(cfg) else None)
    fam = cfg.family
    attn = lambda lp, h: _attn_block(lp, cfg, h, cos_sin,
                                     moe_groups=moe_groups, pol=pol)
    mam = lambda lp, h: _mamba_block(lp, cfg, h, pol)
    if fam in ("dense", "moe"):
        x = _run_stack(params.blocks, attn, x, remat)
    elif fam == "ssm":
        x = _run_stack(params.blocks, mam, x, remat)
    elif fam == "hybrid":
        def group(gp, h):
            return attn(params.shared_attn, _run_stack(gp, mam, h, remat))

        x = _run_stack(params.groups, group, x, remat=False)
        x = _run_stack(params.tail, mam, x, remat)
    elif fam == "audio":
        feats = _encode_audio(params, cfg, aux["frames"], remat=remat,
                              pol=pol)

        def dec(lp, h):
            blk, xblk = lp
            return _cross_block(xblk, cfg, attn(blk, h), feats, pol)

        x = _run_stack(list(zip(params.blocks, params.cross)), dec, x,
                       remat)
    else:                                                   # vlm
        feats = aux["patches"].to(common.dtype(cfg.compute_dtype))

        def group(lp, h):
            gp, xblk = lp
            return _cross_block(xblk, cfg, _run_stack(gp, attn, h, remat),
                                feats, pol)

        x = _run_stack(list(zip(params.groups, params.cross)), group, x,
                       remat=False)
    return x


def forward(params: LM, cfg, tokens, aux=None, *, remat=True,
            moe_groups=None, pol=NO_SHARDING):
    """Full-logits forward (small shapes, tests): (B, T) -> (B, T, V)."""
    x = forward_hidden(params, cfg, tokens, aux, remat=remat,
                       moe_groups=moe_groups, pol=pol)
    return common.unembed(params.embed, cfg, x, pol=pol)


@torch.no_grad()
def prefill(params: LM, cfg, tokens, aux=None, *, moe_groups=None,
            pol=NO_SHARDING):
    """Prefill: the whole prompt, and the logits of its LAST position only
    (B, V); the (B, T, V) tensor is never made.  Sharded (``pol`` of
    ``sharding.make_policy(..., kind="prefill")``, DTensor parameters and
    tokens), the logits are a DTensor."""
    with sharded(pol):
        x = forward_hidden(params, cfg, tokens, aux, remat=False,
                           moe_groups=moe_groups, pol=pol)
        return common.unembed(params.embed, cfg, x[:, -1:, :],
                              pol=pol)[:, 0]


# ---------------------------------------------------------------------------
# Decode.
# ---------------------------------------------------------------------------
def attention_sites(cfg) -> int:
    """Self-attention KV caches a decode step uses (the reference's site
    count): a layer each for dense, moe and audio, a shared-block call
    each for hybrid, a self-attention layer each for vlm, none for ssm."""
    fam = cfg.family
    if fam in ("dense", "moe", "audio"):
        return cfg.num_layers
    if fam == "hybrid":
        return cfg.num_layers // cfg.shared_attn_period
    if fam == "vlm":
        period = cfg.cross_attn_period
        return (cfg.num_layers // period) * (period - 1)
    return 0


def cross_sites(cfg) -> int:
    """Cross-attention layers: audio's num_layers, vlm's one a group."""
    if cfg.family == "audio":
        return cfg.num_layers
    if cfg.family == "vlm":
        return cfg.num_layers // cfg.cross_attn_period
    return 0


def mamba_layers(cfg) -> int:
    """Mamba2 layers (each with its own cache): ssm's and hybrid's."""
    return cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0


class Cache(NamedTuple):
    """Decode state.

    attn_k/attn_v: (sites, B, Tmax, Kv, hd) with ``attention_sites``
    sites, written in place by each step (None without attention);
    mamba: a list of :class:`ssm.MambaCache`, one a Mamba layer in the
    order decode meets them (hybrid: group by group, then the tail),
    float32 and updated in place; cross_k/cross_v: (cross_sites, B, S, Kv,
    hd) from :func:`precompute_cross_kv` (audio and vlm); pos: the next
    position, a host int, so no step reads it back from the device.
    """

    attn_k: Optional[torch.Tensor] = None
    attn_v: Optional[torch.Tensor] = None
    mamba: Optional[List[ssm.MambaCache]] = None
    cross_k: Optional[torch.Tensor] = None
    cross_v: Optional[torch.Tensor] = None
    pos: int = 0


def init_cache(cfg, batch: int, max_len: int, device="cpu") -> Cache:
    """A zeroed cache.  Attention caches take ``cfg.compute_dtype``, the
    dtype of every q the decode step makes (the kernel takes k and v only
    in q's dtype); Mamba caches are float32, as the reference's
    ``init_cache`` makes them.  Audio and vlm still need the cross K/V
    (:func:`precompute_cross_kv`)."""
    _check_family(cfg)
    sites = attention_sites(cfg)
    k = v = mamba = None
    if sites:
        shape = (sites, batch, max_len, cfg.num_kv_heads, cfg.hd())
        dt = common.dtype(cfg.compute_dtype)
        k = torch.zeros(shape, dtype=dt, device=device)
        v = torch.zeros(shape, dtype=dt, device=device)
    if mamba_layers(cfg):
        mamba = [ssm.init_mamba_cache(cfg, batch, device=device)
                 for _ in range(mamba_layers(cfg))]
    return Cache(attn_k=k, attn_v=v, mamba=mamba, pos=0)


@torch.no_grad()
def precompute_cross_kv(params: LM, cfg, feats, *, pol=NO_SHARDING):
    """Project frontend features (B, S, d) once into every cross layer's
    K/V: two (cross_sites, B, S, Kv, hd) tensors in ``compute_dtype``
    (sharded: DTensors placed as ``sharding.cache_shardings`` places a
    cache's cross K/V for a batch of B)."""
    with sharded(pol):
        ks, vs = zip(*(common.cross_kv(xp.xattn, cfg, feats, pol)
                       for xp in params.cross))
        ks, vs = torch.stack(ks), torch.stack(vs)
    if pol.mesh is None:
        return ks, vs
    from repro_torch.distributed import sharding
    layout = sharding.cache_shardings(
        pol.mesh, {"cross_k": ks, "cross_v": vs}, batch=feats.shape[0])
    return tuple(t.redistribute(pol.mesh, layout[k].placements)
                 for k, t in (("cross_k", ks), ("cross_v", vs)))


@torch.no_grad()
def decode_step(params: LM, cfg, cache: Cache, token, *, pol=NO_SHARDING):
    """One decode step.  token: (B,) int -> (logits (B, V), cache with
    pos + 1).  The cache's tensors are updated in place; audio and vlm
    need its cross K/V.  Sharded (``pol`` of ``sharding.make_policy(...,
    kind="decode")``, DTensor parameters, a cache placed by
    ``sharding.place_cache``), the logits are a DTensor; ``token`` may be
    a plain tensor, the same on every rank."""
    with sharded(pol):
        return _decode_step(params, cfg, cache, token, pol)


def _decode_step(params: LM, cfg, cache: Cache, token, pol):
    _check_family(cfg)
    pos, fam = cache.pos, cfg.family
    if cache.attn_k is not None and pos >= cache.attn_k.shape[2]:
        raise ValueError(f"cache full: position {pos} of "
                         f"{cache.attn_k.shape[2]}")
    if cross_sites(cfg) and cache.cross_k is None:
        raise ValueError(f"family {fam!r} decodes against cross K/V: set "
                         "the cache's cross_k / cross_v from "
                         "precompute_cross_kv")
    B = token.shape[0]
    dev = token.device
    x = common.embed(params.embed, cfg, token[:, None], pol=pol)
    cos_sin = (common.rope_tables(torch.full((B, 1), pos, device=dev),
                                  cfg.hd(), cfg.rope_theta)
               if cache.attn_k is not None else None)

    def attn_site(p, h, site):
        hn = _norm(h, p.ln1, cfg, pol)
        h = h + common.decode_attention_step(
            p.attn, cfg, hn, cache.attn_k[site], cache.attn_v[site], pos,
            cos_sin=cos_sin, pol=pol)
        z = _norm(h, p.ln2, cfg, pol)
        if isinstance(p, MoEBlock):
            return h + moe.moe_ffn(p.moe, cfg, z, n_groups=1, pol=pol)
        return h + common.mlp(p.mlp, cfg, z, pol=pol)

    def mamba_layer(p, h, mc):
        out, _ = ssm.mamba_step(p.mamba, cfg, _norm(h, p.ln1, cfg, pol), mc,
                                pol=pol)
        return h + out

    def cross_layer(p, h, i):
        hn = _norm(h, p.ln1, cfg, pol)
        h = h + common.cross_attention_step(p.xattn, cfg, hn,
                                            cache.cross_k[i],
                                            cache.cross_v[i], pol=pol)
        return h + common.mlp(p.mlp, cfg, _norm(h, p.ln2, cfg, pol),
                              pol=pol)

    if fam in ("dense", "moe"):
        for i, p in enumerate(params.blocks):
            x = attn_site(p, x, i)
    elif fam == "ssm":
        for p, mc in zip(params.blocks, cache.mamba):
            x = mamba_layer(p, x, mc)
    elif fam == "hybrid":
        mcs = iter(cache.mamba)
        for g, group in enumerate(params.groups):
            for p in group:
                x = mamba_layer(p, x, next(mcs))
            x = attn_site(params.shared_attn, x, g)
        for p in params.tail:
            x = mamba_layer(p, x, next(mcs))
    elif fam == "audio":
        for i, (p, xp) in enumerate(zip(params.blocks, params.cross)):
            x = cross_layer(xp, attn_site(p, x, i), i)
    else:                                                   # vlm
        site = 0
        for g, (group, xp) in enumerate(zip(params.groups, params.cross)):
            for p in group:
                x = attn_site(p, x, site)
                site += 1
            x = cross_layer(xp, x, g)
    logits = common.unembed(params.embed, cfg, x, pol=pol)
    return logits[:, 0, :], cache._replace(pos=pos + 1)


def serve_step(params: LM, cache: Cache, token, cfg, *, pol=NO_SHARDING):
    """One batched greedy decode step: (B,) token ids -> (B,) next ids, a
    plain tensor (sharded: the whole logits gathered on every rank, so
    every rank reads the same ids)."""
    logits, cache = decode_step(params, cfg, cache, token, pol=pol)
    if isinstance(logits, DTensor):
        logits = logits.full_tensor()
    return torch.argmax(logits, dim=-1), cache


# ---------------------------------------------------------------------------
# Loss and train steps.
# ---------------------------------------------------------------------------
CE_CHUNK = 512  # sequence positions per chunked-cross-entropy step


def _chunk_nll(embed, cfg, xchunk, lchunk, pol=NO_SHARDING):
    """Summed next-token NLL of one chunk: float32 logits, log-softmax."""
    logits = common.unembed(embed, cfg, xchunk, pol=pol).to(torch.float32)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), lchunk.reshape(-1).long(),
        reduction="sum")


def lm_loss(params: LM, cfg, tokens, labels, aux=None, *, moe_groups=None,
            remat=True, pol=NO_SHARDING):
    """Mean next-token cross-entropy with a *chunked* unembedding: logits
    are made and consumed CE_CHUNK positions at a time (the chunk lowered
    until it divides T), each chunk under ``checkpoint`` so its logits
    are recomputed in the backward and the (B, T, V) tensor never exists.
    The chunks' sums add up in float32 in order, over B * T."""
    with sharded(pol):
        x = forward_hidden(params, cfg, tokens, aux, moe_groups=moe_groups,
                           remat=remat, pol=pol)
        B, T, _ = x.shape
        ck = min(CE_CHUNK, T)
        while T % ck:
            ck -= 1
        total = None
        for i in range(0, T, ck):
            xc, lc = x[:, i:i + ck], labels[:, i:i + ck]
            nll = (checkpoint(_chunk_nll, params.embed, cfg, xc, lc, pol,
                              use_reentrant=False)
                   if torch.is_grad_enabled()
                   else _chunk_nll(params.embed, cfg, xc, lc, pol))
            total = nll if total is None else total + nll
        return total / (B * T)


_SHARDED = threading.local()


@contextlib.contextmanager
def sharded(pol: ShardingPolicy):
    """The context of a sharded computation: plain tensors met beside
    DTensors (RoPE tables, masks, positions) count as replicated.  A
    no-op for the default policy; nested, only the outermost one acts
    (``implicit_replication`` does not restore an outer one's state)."""
    depth = getattr(_SHARDED, "depth", 0)
    if pol.mesh is None or depth:
        yield
        return
    _SHARDED.depth = 1
    try:
        with implicit_replication():
            yield
    finally:
        _SHARDED.depth = 0


def _trainable(params: LM) -> Dict[str, torch.Tensor]:
    """The model's parameters by name, set to require gradients."""
    named = dict(params.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    return named


def _loss_and_grads(params, named, cfg, batch, moe_groups, remat,
                    pol=NO_SHARDING):
    """The loss (a plain tensor, the same on every rank when sharded)
    and each parameter's gradient in its parameter's placement (the
    data-parallel sums reduced: all-reduced where the parameter is
    replicated, reduce-scattered where it is sharded)."""
    aux = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    with torch.enable_grad(), sharded(pol):
        loss = lm_loss(params, cfg, batch["tokens"], batch["labels"],
                       aux or None, moe_groups=moe_groups, remat=remat,
                       pol=pol)
        # An expert no token reached is outside the graph: its gradient is
        # 0, as the reference's dense dispatch gives it.
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
    grads = dict(zip(named, grads))
    if isinstance(loss, DTensor):
        loss = loss.full_tensor()
        for k, p in named.items():
            g = grads[k]
            if tuple(g.placements) != tuple(p.placements):
                grads[k] = g.redistribute(p.device_mesh, p.placements)
    return loss.detach(), grads


def train_step(params: LM, opt_state, batch, cfg, optimizer, *,
               moe_groups=None, remat=True, pol=NO_SHARDING):
    """One optimizer step.  batch: {"tokens": (B, T), "labels": (B, T)}
    plus the frontend stub for audio / vlm.  The model and
    ``opt_state`` are updated in place and returned with the loss.

    Sharded: the parameters and moments are DTensors placed by
    ``sharding.distribute_model`` / ``distribute_opt_state``, the batch
    by ``sharding.place_batch`` and ``pol`` is ``sharding.make_policy``'s;
    the loss comes back as a plain tensor, the same on every rank, and
    the clipping norm is over the whole gradient."""
    named = _trainable(params)
    loss, grads = _loss_and_grads(params, named, cfg, batch, moe_groups,
                                  remat, pol)
    with sharded(pol):
        opt_state = optimizer.update_(grads, opt_state, named)
    return params, opt_state, loss


def _micro(v, i, b):
    """Rows [i * b, (i + 1) * b) of a batch tensor; a DTensor's slice is
    placed as the batch was when its rows divide evenly (else as DTensor
    leaves the slice)."""
    mb = v[i * b:(i + 1) * b]
    if not isinstance(v, DTensor) or mb.placements == v.placements:
        return mb
    mesh = v.device_mesh
    n = 1
    for d, pl in enumerate(v.placements):
        if pl.is_shard(0):
            n *= mesh.size(d)
    return mb.redistribute(mesh, v.placements) if b % n == 0 else mb


def train_step_accum(params: LM, opt_state, batch, cfg, optimizer, *,
                     n_micro: int = 1, moe_groups=None, pol=NO_SHARDING):
    """One optimizer step with gradient accumulation over ``n_micro``
    slices of the batch along axis 0, into float32 accumulators; the
    gradient is their sum over ``n_micro`` and the loss the mean of the
    slices'.  ``n_micro == 1`` is :func:`train_step`."""
    if n_micro == 1:
        return train_step(params, opt_state, batch, cfg, optimizer,
                          moe_groups=moe_groups, pol=pol)
    B = batch["tokens"].shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} is not a multiple of n_micro "
                         f"{n_micro}")
    b = B // n_micro
    named = _trainable(params)
    loss_acc = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
    acc = {k: torch.zeros_like(p, dtype=torch.float32)
           for k, p in named.items()}
    for i in range(n_micro):
        mb = {k: _micro(v, i, b) for k, v in batch.items()}
        loss, grads = _loss_and_grads(params, named, cfg, mb, moe_groups,
                                      True, pol)
        loss_acc = loss_acc + loss
        for k, g in grads.items():
            acc[k].add_(g)
    with sharded(pol):
        grads = {k: g / n_micro for k, g in acc.items()}
        opt_state = optimizer.update_(grads, opt_state, named)
    return params, opt_state, loss_acc / n_micro
