"""Shared model primitives of the PyTorch port.

The counterpart of the JAX package's ``models/common.py``: norms, RoPE,
the attention and MLP parameters, full-sequence (training / prefill)
self- and cross-attention, the one-token decode steps, the
cross-attention decode pieces (the reference's ``lm.precompute_cross_kv``
per layer and ``lm._cross_step_cached``), embedding and unembedding.  The
layout is the JAX package's: weights are ``(in, out)`` and applied as
``x @ W``, and a KV cache is ``(B, Tmax, Kv, hd)``, so weights carry
across without a transpose.

Differences from the reference, all of them value-preserving:

* Weight matrices, biases and the token embedding are stored in the
  config's ``compute_dtype`` (cast once, at load) for serving, where the
  reference keeps float32 parameters and casts them at each use; norm
  gains stay float32, as the reference's norms read them.  A model built
  with float32 storage (:func:`stored`, training's master weights) is
  the reference's layout: every use goes through :func:`cast`.
* :func:`decode_attention_step` writes this step's key and value into the
  cache in place, where the reference returns updated copies.
* A decode cache sharded on its sequence (a DTensor placed by the
  ``cache`` hook's layout, :func:`repro_torch.distributed.sharding.
  cache_shardings`) is attended in ``local_map``
  (:func:`_sharded_decode_attention`): each rank writes the new row if it
  holds it and makes the flash-decode partials of its valid rows, the
  partials are gathered over the mesh dim that splits the sequence, in
  sequence order, and combined (the combine kernel on the card), in a
  fixed order.  XLA partitions the reference's softmax over the sharded
  sequence on its own; the kernel has no DTensor strategy.
* Its attention goes through :func:`repro_torch.kernels.ops.decode_attention`
  over the cache's first ``pos + 1`` rows, the flash-decode kernel on the
  card.  The reference masks rows past ``pos`` with -1e30 and takes a
  softmax over all ``Tmax`` rows; ``exp(-1e30 - m)`` is exactly 0 in
  float32, so the two agree up to the order of the sums.
* :func:`cross_attention_step` attends over all S precomputed keys through
  the same call.  The reference casts its float32 softmax weights to
  ``x``'s dtype before the product with V, where the kernel keeps float32
  throughout: a float32 model agrees up to the order of the sums, a
  bfloat16 one up to that rounding (as in the self-attention step).

The full-sequence paths (:func:`attention`, :func:`cross_attention`) are
plain tensor operations in the reference's order and precision: scores
in float32 and softmax weights cast to ``x``'s dtype before P.V up to
``FLASH_THRESHOLD`` queries, and past it :func:`blockwise_attention`,
the online softmax over KV chunks with float32 accumulators and the
ragged tail masked.

Sharding: model code never builds a mesh.  A :class:`ShardingPolicy`
carries the reference's hooks for the residual stream, the attention and
ffn internals, the MoE dispatch and the Mamba heads, at the reference's
sites, plus ``weight``, a parameter's placement at its use (:func:`cast`;
the FSDP gather, which XLA inserts on its own).  The default policy is a
no-op; ``repro_torch.distributed.sharding.make_policy`` builds the real
ones, whose hooks redistribute DTensors.  A product with a DTensor weight
is weight-stationary over the mesh (:func:`_dense`): the activation moves
to the weight's layout, never the weight to the activation's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops

NORM_PARAMS = ("ln1", "ln2", "norm_f", "q_norm", "k_norm")
BIAS_PARAMS = ("bq", "bk", "bv")


def _same(x):
    return x


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Constraint hooks applied inside model code (no-ops by default)."""

    resid: Callable = _same         # (B, T, D)
    heads: Callable = _same         # (B, T, H, hd)
    kv_full: Callable = _same       # (B, S, Kv, hd)
    ffn: Callable = _same           # (B, T, F)
    experts: Callable = _same       # (..., E, C, D/F)
    dispatch: Callable = _same      # (n, g, E*C)
    experts_flat: Callable = _same  # (n, E*C, D/F)
    ssm_x: Callable = _same         # (B, T, H, P)
    logits: Callable = _same        # (B, T, V)
    cache: Callable = _same         # (B, T, Kv, hd)
    weight: Callable = _same        # a parameter, at its use
    mesh: Any = None                # the DeviceMesh of the hooks


NO_SHARDING = ShardingPolicy()


def dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16", "float32")."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def stored(cfg, dt=None):
    """The config the parameter constructors read: ``cfg`` itself (matrices
    stored in ``compute_dtype``), or with matrices stored in ``dt``, such
    as float32 master weights for training, which the forward casts to
    ``compute_dtype`` at each use (:func:`cast`)."""
    if dt is None:
        return cfg
    return dataclasses.replace(cfg, compute_dtype=str(dt).rsplit(".", 1)[-1])


def cast(w, cfg, pol=NO_SHARDING):
    """``w`` in ``cfg.compute_dtype``: ``w`` itself when it is stored so
    (serving), a copy when it is a float32 master weight (training), as
    the reference casts its float32 parameters at each use.  A sharded
    ``w`` first takes the placement of its use (``pol.weight``: gathered
    in float32, so gradients are reduced in float32)."""
    w = pol.weight(w)
    dt = dtype(cfg.compute_dtype)
    return w if w.dtype == dt else w.to(dt)


def param(shape, dt, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                        requires_grad=False)


def rms_norm(x, gamma, eps=1e-6):
    """RMS norm computed in float32 and returned in ``x``'s dtype."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * gamma.to(torch.float32)
            ).to(x.dtype)


def rope_tables(positions, hd: int, theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotary angles: positions (..., T) -> two float32
    tensors (..., T, 1, hd // 2) that broadcast over the heads."""
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x, cos, sin):
    """Rotate x (..., T, H, hd) by the tables of :func:`rope_tables`."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _stationary(x, w):
    """``x`` placed so that ``x @ w`` runs where ``w`` lies: a mesh dim
    that shards w's output dim (column-parallel) needs all of x's
    features and rows there (replicated), one that shards w's input dim
    (row-parallel, a Partial sum out) needs x's features split alike; a
    dim that replicates w leaves x as it is.  So no weight moves for a
    product; a plain ``x`` or ``w`` is left alone."""
    if not isinstance(w, DTensor) or not isinstance(x, DTensor):
        return x
    want = []
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(wp, Shard):
            want.append(Replicate() if wp.dim == w.dim() - 1
                        else Shard(x.dim() - 1))
        else:
            want.append(xp)
    want = tuple(want)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


_PROJ = threading.local()


@contextlib.contextmanager
def projection():
    """Marks the products run inside it as weight projections, products
    with no batch dims (``remat="dots"`` keeps their outputs)."""
    _PROJ.depth = getattr(_PROJ, "depth", 0) + 1
    try:
        yield
    finally:
        _PROJ.depth -= 1


def in_projection() -> bool:
    return getattr(_PROJ, "depth", 0) > 0


def _dense(x, w, b=None):
    """x @ w (+ b) over the last axis: a weight projection
    (:func:`projection`)."""
    if isinstance(w, DTensor):
        x = _stationary(x, w)
    with projection():
        if b is None:
            return x @ w
        flat = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return flat.reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# Attention.
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """Attention parameters: wq (d, H*hd), wk/wv (d, Kv*hd), wo (H*hd, d);
    bq/bk/bv with ``qkv_bias``; q_norm/k_norm (hd,) with ``qk_norm``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d = cfg.d_model
        hd, H, Kv = cfg.hd(), cfg.num_heads, cfg.num_kv_heads
        dt = dtype(cfg.compute_dtype)
        self.wq = param((d, H * hd), dt, device)
        self.wk = param((d, Kv * hd), dt, device)
        self.wv = param((d, Kv * hd), dt, device)
        self.wo = param((H * hd, d), dt, device)
        if cfg.qkv_bias:
            self.bq = param((H * hd,), dt, device)
            self.bk = param((Kv * hd,), dt, device)
            self.bv = param((Kv * hd,), dt, device)
        if cfg.qk_norm:
            self.q_norm = param((hd,), torch.float32, device)
            self.k_norm = param((hd,), torch.float32, device)


def _project_qkv(p: Attention, cfg, x, cos_sin, pol=NO_SHARDING):
    """q (B, T, H, hd), k and v (B, T, Kv, hd) from x (B, T, d), rotated by
    the (cos, sin) tables of :func:`rope_tables`."""
    B, T, _ = x.shape
    hd, H, Kv = cfg.hd(), cfg.num_heads, cfg.num_kv_heads
    bias = cfg.qkv_bias
    c = lambda w: cast(w, cfg, pol)
    q = _dense(x, c(p.wq), c(p.bq) if bias else None)
    k = _dense(x, c(p.wk), c(p.bk) if bias else None)
    v = _dense(x, c(p.wv), c(p.bv) if bias else None)
    q = pol.heads(_heads(q, (B, T, H, hd)))
    k, v = _heads(k, (B, T, Kv, hd)), _heads(v, (B, T, Kv, hd))
    if cfg.qk_norm:
        q = rms_norm(q, pol.weight(p.q_norm), cfg.norm_eps)
        k = rms_norm(k, pol.weight(p.k_norm), cfg.norm_eps)
    return apply_rope(q, *cos_sin), apply_rope(k, *cos_sin), v


def _heads(x, shape):
    """x (B, T, n * hd) -> (B, T, n, hd).  A DTensor whose last dim is
    split where n is not (a GQA ``wk`` of Kv * hd columns on a mesh that
    Kv does not divide) is first gathered on that dim, so no rank reads a
    wrong view of a head."""
    if isinstance(x, DTensor):
        want = tuple(
            Replicate() if (isinstance(pl, Shard) and pl.dim == x.dim() - 1
                            and shape[2] % x.device_mesh.size(i)) else pl
            for i, pl in enumerate(x.placements))
        if want != tuple(x.placements):
            x = x.redistribute(x.device_mesh, want)
    return x.reshape(shape)


def _gqa_scores(q, k, scale):
    """q (B, T, H, hd), k (B, S, Kv, hd) -> scores (B, Kv, G, T, S) in q's
    dtype, scaled after the product as the reference scales them."""
    B, T, H, hd = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, T, Kv, H // Kv, hd)
    return torch.einsum("btkgd,bskd->bkgts", qg, k) * scale


# Query lengths past FLASH_THRESHOLD take the blockwise path, an online
# softmax over KV chunks of KV_CHUNK keys that never holds (T, S) scores
# (the reference's constants).
FLASH_THRESHOLD = 1024
KV_CHUNK = 1024


def blockwise_attention(q, k, v, *, causal=True, kv_chunk=KV_CHUNK):
    """Memory-bounded attention: q (B, T, H, hd), k / v (B, S, Kv, hd) ->
    (B, T, H * hd) in q's dtype.

    The reference's recurrence: every query row advances together over
    chunks of ``kv_chunk`` keys, with the running max, sum and output in
    float32; a ragged last chunk (1,500 audio frames, 1,601 vision
    patches) is zero-padded and its padding masked with -1e30.  Live
    memory is one (B, Kv, G, T, ck) score tile.
    """
    B, T, H, hd = q.shape
    S, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    ck = min(kv_chunk, S)
    pad = (-S) % ck
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nk = (S + pad) // ck
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    qg = q.reshape(B, T, Kv, G, hd).to(f32)
    q_pos = torch.arange(T, device=q.device)
    m = torch.full((B, Kv, G, T), -1e30, dtype=f32, device=q.device)
    l = torch.zeros((B, Kv, G, T), dtype=f32, device=q.device)
    acc = torch.zeros((B, Kv, G, T, hd), dtype=f32, device=q.device)
    for ki in range(nk):
        kc = k[:, ki * ck:(ki + 1) * ck].to(f32)
        vc = v[:, ki * ck:(ki + 1) * ck].to(f32)
        s = torch.einsum("btkgd,bskd->bkgts", qg, kc) * scale
        k_pos = ki * ck + torch.arange(ck, device=q.device)
        if causal:
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, -1e30)
        if pad:
            s = torch.where(k_pos[None, :] < S, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = (acc * corr[..., None]
               + torch.einsum("bkgts,bskd->bkgtd", p, vc))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]      # (B,Kv,G,T,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H * hd).to(q.dtype)


def _direct_attention(q, k, v, x_dtype, causal):
    """Attention with the whole (T, S) score matrix: scores in float32,
    softmax weights cast to ``x_dtype`` before the product with V, as the
    reference computes it.  Returns (B, T, H * hd)."""
    B, T, H, hd = q.shape
    s = _gqa_scores(q, k, 1.0 / math.sqrt(hd)).to(torch.float32)
    if causal:
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1).to(x_dtype)
    return torch.einsum("bkgts,bskd->btkgd", w, v).reshape(B, T, H * hd)


def _attend(q, k, v, x_dtype, causal):
    """The direct path up to FLASH_THRESHOLD queries, blockwise past it."""
    if q.shape[1] > FLASH_THRESHOLD:
        return blockwise_attention(q, k, v, causal=causal)
    return _direct_attention(q, k, v, x_dtype, causal)


def attention(p: Attention, cfg, x, positions, *, causal=True,
              cos_sin=None, pol=NO_SHARDING):
    """Full (training / prefill) self-attention.  x: (B, T, D), positions
    (B, T); ``cos_sin`` may carry their RoPE tables (:func:`rope_tables`),
    computed once for a forward.  Returns (B, T, D)."""
    if cos_sin is None:
        cos_sin = rope_tables(positions, cfg.hd(), cfg.rope_theta)
    q, k, v = _project_qkv(p, cfg, x, cos_sin, pol)
    k, v = pol.kv_full(k), pol.kv_full(v)
    return pol.resid(_dense(_attend(q, k, v, x.dtype, causal),
                            cast(p.wo, cfg, pol)))


def cross_attention(p: Attention, cfg, x, kv_feats, *, pol=NO_SHARDING):
    """x: (B, T, D) queries over kv_feats (B, S, D): no RoPE, no mask,
    q_norm / k_norm under ``qk_norm``.  Returns (B, T, D)."""
    B, T, _ = x.shape
    hd, H = cfg.hd(), cfg.num_heads
    q = _heads(_dense(x, cast(p.wq, cfg, pol)), (B, T, H, hd))
    if cfg.qk_norm:
        q = rms_norm(q, pol.weight(p.q_norm), cfg.norm_eps)
    k, v = cross_kv(p, cfg, kv_feats, pol)
    q = pol.heads(q)
    k, v = pol.kv_full(k), pol.kv_full(v)
    return pol.resid(_dense(_attend(q, k, v, x.dtype, False),
                            cast(p.wo, cfg, pol)))


def decode_attention_step(p: Attention, cfg, x, cache_k, cache_v, pos: int,
                          *, cos_sin=None, pol=NO_SHARDING):
    """One-token attention against a KV cache.

    x: (B, 1, D); cache_k/v: (B, Tmax, Kv, hd), written in place at row
    ``pos`` (a host int); ``cos_sin`` may carry this position's RoPE
    tables, computed once per step.  Returns out (B, 1, D); the reference
    also returns the updated caches, which here are the ones passed in.
    A DTensor cache must be in the layout of ``pol.cache`` (the step
    writes its shards in place, so it is never redistributed).
    """
    B = x.shape[0]
    hd, H = cfg.hd(), cfg.num_heads
    if cos_sin is None:
        cos_sin = rope_tables(torch.full((B, 1), pos, device=x.device), hd,
                              cfg.rope_theta)
    q, k, v = _project_qkv(p, cfg, x, cos_sin, pol)
    if isinstance(cache_k, DTensor):
        for c in (cache_k, cache_v):
            if pol.cache(c) is not c:
                raise ValueError("a sharded KV cache must be in the "
                                 "layout of pol.cache (place it with "
                                 "sharding.place_cache)")
        o = _sharded_decode_attention(q[:, 0], cache_k, cache_v, pos + 1,
                                      new=(k[:, 0], v[:, 0], pos))
    else:
        cache_k[:, pos].copy_(k[:, 0])
        cache_v[:, pos].copy_(v[:, 0])
        o = ops.decode_attention(q[:, 0], cache_k[:, :pos + 1],
                                 cache_v[:, :pos + 1])      # (B, H, hd) f32
    o = o.to(x.dtype).reshape(B, 1, H * hd)
    return pol.resid(_dense(o, cast(p.wo, cfg, pol)))


def all_gather(x, mesh, mesh_dim: int, dim: int):
    """The local tensors ``x`` of the ranks along mesh dim ``mesh_dim``,
    concatenated on ``dim`` in the order of their coordinates there (a
    blocking all-gather, for code inside ``local_map``)."""
    import torch.distributed as dist

    n = mesh.size(mesh_dim)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.get_group(mesh_dim))
    return torch.cat(out.chunk(n), dim=dim) if dim else out


def _sharded_decode_attention(q, cache_k, cache_v, rows: int, new=None):
    """:func:`ops.decode_attention` of q (B, Hq, D) over the first
    ``rows`` rows of a DTensor cache (B, T, Kv, D), after writing ``new``
    = (k, v, pos) into row ``pos`` of it, in ``local_map``.  Returns
    (B, Hq, D) float32, split on B as the cache is and whole on every
    other mesh dim.

    A mesh dim that splits the sequence (the ``model`` axis under the
    decode layout; a dim of size 1 too) gives rank r of its m ranks rows
    [r * Tl, (r + 1) * Tl) of the cache: the rank writes row ``pos`` if
    it holds it, makes the partials (acc, m, l) of its valid rows
    ``min(Tl, max(0, rows - r * Tl))`` (the neutral partial where it has
    none), as many a row as every other rank gives
    (:func:`ops.decode_attention_partials`), and the partials of the m
    ranks are gathered in rank order, which is sequence order, and
    combined.  A cache whose sequence no mesh dim
    splits is attended whole on each rank."""
    from torch.distributed.tensor.experimental import local_map

    mesh = cache_k.device_mesh
    cpl = tuple(cache_k.placements)
    seq = [i for i, pl in enumerate(cpl) if pl.is_shard(1)]
    if len(seq) > 1 or any(pl.is_shard() and pl.dim > 1 for pl in cpl):
        raise ValueError(f"a decode cache shards its batch and sequence "
                         f"only, on one mesh dim each; got {cpl}")
    rep = tuple(Shard(0) if pl.is_shard(0) else Replicate() for pl in cpl)
    m = mesh.size(seq[0]) if seq else 1
    r = mesh.get_local_rank(seq[0]) if seq else 0
    T = cache_k.shape[1]
    Tl = T // m
    if Tl * m != T:
        raise ValueError(f"a cache of {T} rows does not split evenly over "
                         f"{m} ranks")

    def local(ql, ck, cv, kl=None, vl=None):
        start = r * Tl
        if new is not None and start <= new[2] < start + Tl:
            ck[:, new[2] - start].copy_(kl)
            cv[:, new[2] - start].copy_(vl)
        n = min(Tl, max(0, rows - start))
        if not seq:
            return ops.decode_attention(ql, ck[:, :n], cv[:, :n])
        parts = ops.decode_attention_partials(ql, ck[:, :n], cv[:, :n],
                                              m, Tl)
        if m > 1:
            parts = all_gather(parts, mesh, seq[0], dim=2)
        return ops.decode_attention_combine(parts)

    args = (q, cache_k, cache_v)
    if new is not None:
        args += (new[0], new[1])
    fn = local_map(local, out_placements=list(rep),
                   in_placements=(rep, cpl, cpl) + (rep,) * (len(args) - 3),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(*args)


def cross_kv(p: Attention, cfg, feats, pol=NO_SHARDING):
    """Cross-attention keys and values of one layer from frontend features
    (B, S, d): ``feats @ wk`` and ``feats @ wv`` without bias or RoPE,
    ``k_norm`` under ``qk_norm``.  Returns k, v (B, S, Kv, hd) in
    ``compute_dtype`` (the features are cast to it first)."""
    B, S, _ = feats.shape
    hd, Kv = cfg.hd(), cfg.num_kv_heads
    feats = feats.to(dtype(cfg.compute_dtype))
    k = _heads(_dense(feats, cast(p.wk, cfg, pol)), (B, S, Kv, hd))
    v = _heads(_dense(feats, cast(p.wv, cfg, pol)), (B, S, Kv, hd))
    if cfg.qk_norm:
        k = rms_norm(k, pol.weight(p.k_norm), cfg.norm_eps)
    return k, v


def cross_attention_step(p: Attention, cfg, x, k, v, *, pol=NO_SHARDING):
    """One token's cross-attention over precomputed k, v (B, S, Kv, hd):
    ``q = x @ wq`` without bias or RoPE, ``q_norm`` under ``qk_norm``, no
    mask.  x: (B, 1, D) -> (B, 1, D).  DTensor k, v (the cache's layout,
    :func:`repro_torch.models.lm.precompute_cross_kv` with ``pol``) are
    attended shard by shard (:func:`_sharded_decode_attention`)."""
    B = x.shape[0]
    hd, H = cfg.hd(), cfg.num_heads
    q = _heads(_dense(x, cast(p.wq, cfg, pol)), (B, 1, H, hd))[:, 0]
    if cfg.qk_norm:
        q = rms_norm(q, pol.weight(p.q_norm), cfg.norm_eps)
    if isinstance(k, DTensor):
        o = _sharded_decode_attention(q, k, v, k.shape[1])
    else:
        o = ops.decode_attention(q, k, v)                  # (B, H, hd) f32
    return _dense(o.to(x.dtype).reshape(B, 1, H * hd), cast(p.wo, cfg, pol))


# ---------------------------------------------------------------------------
# MLP.
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """SwiGLU (w_gate, w_up (d, f), w_down (f, d)) or GELU (w_up, w_down)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        dt = dtype(cfg.compute_dtype)
        if cfg.mlp_act == "swiglu":
            self.w_gate = param((d, f), dt, device)
        self.w_up = param((d, f), dt, device)
        self.w_down = param((f, d), dt, device)


def mlp(p: MLP, cfg, x, *, pol=NO_SHARDING):
    c = lambda w: cast(w, cfg, pol)
    if cfg.mlp_act == "swiglu":
        h = F.silu(_dense(x, c(p.w_gate))) * _dense(x, c(p.w_up))
    else:
        h = F.gelu(_dense(x, c(p.w_up)),
                   approximate="tanh")                # jax.nn.gelu's default
    h = pol.ffn(h)
    return pol.resid(_dense(h, c(p.w_down)))


# ---------------------------------------------------------------------------
# Embedding / unembedding.
# ---------------------------------------------------------------------------
class Embed(nn.Module):
    """tok (V, d), norm_f (d,) and, unless tied, unembed (d, V)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dt = dtype(cfg.compute_dtype)
        self.tok = param((cfg.vocab_size, cfg.d_model), dt, device)
        self.norm_f = param((cfg.d_model,), torch.float32, device)
        if not cfg.tie_embeddings:
            self.unembed = param((cfg.d_model, cfg.vocab_size), dt, device)


def embed(p: Embed, cfg, tokens, *, pol=NO_SHARDING):
    return pol.resid(F.embedding(tokens, cast(p.tok, cfg, pol)))


def unembed(p: Embed, cfg, x, *, pol=NO_SHARDING):
    x = rms_norm(x, pol.weight(p.norm_f), cfg.norm_eps)
    w = cast(p.tok, cfg, pol).T if cfg.tie_embeddings else cast(
        p.unembed, cfg, pol)
    return pol.logits(_dense(x, w))
