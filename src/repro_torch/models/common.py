"""Shared model primitives of the PyTorch port: what one decode step needs.

The counterpart of the JAX package's ``models/common.py`` for the decode
path: norms, RoPE, the attention and MLP parameters and their one-token
steps, the cross-attention decode pieces (the reference's
``lm.precompute_cross_kv`` per layer and ``lm._cross_step_cached``),
embedding and unembedding.  The layout is the JAX
package's: weights are ``(in, out)`` and applied as ``x @ W``, and a KV
cache is ``(B, Tmax, Kv, hd)``, so weights carry across without a
transpose.

Differences from the reference, all of them value-preserving:

* Weight matrices, biases and the token embedding are stored in the
  config's ``compute_dtype`` (cast once, at load), where the reference
  keeps float32 parameters and casts them at each use; norm gains stay
  float32, as the reference's norms read them.
* :func:`decode_attention_step` writes this step's key and value into the
  cache in place, where the reference returns updated copies.
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

The forward (training / prefill) paths -- ``attention``,
``blockwise_attention``, ``cross_attention`` -- are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops

NORM_PARAMS = ("ln1", "ln2", "norm_f", "q_norm", "k_norm")
BIAS_PARAMS = ("bq", "bk", "bv")


def dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16", "float32")."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


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


def _dense(x, w, b=None):
    """x @ w (+ b) over the last axis."""
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


def _project_qkv(p: Attention, cfg, x, cos_sin):
    """q (B, T, H, hd), k and v (B, T, Kv, hd) from x (B, T, d), rotated by
    the (cos, sin) tables of :func:`rope_tables`."""
    B, T, _ = x.shape
    hd, H, Kv = cfg.hd(), cfg.num_heads, cfg.num_kv_heads
    q = _dense(x, p.wq, p.bq if cfg.qkv_bias else None).reshape(B, T, H, hd)
    k = _dense(x, p.wk, p.bk if cfg.qkv_bias else None).reshape(B, T, Kv, hd)
    v = _dense(x, p.wv, p.bv if cfg.qkv_bias else None).reshape(B, T, Kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return apply_rope(q, *cos_sin), apply_rope(k, *cos_sin), v


def decode_attention_step(p: Attention, cfg, x, cache_k, cache_v, pos: int,
                          *, cos_sin=None):
    """One-token attention against a KV cache.

    x: (B, 1, D); cache_k/v: (B, Tmax, Kv, hd), written in place at row
    ``pos`` (a host int); ``cos_sin`` may carry this position's RoPE
    tables, computed once per step.  Returns out (B, 1, D); the reference
    also returns the updated caches, which here are the ones passed in.
    """
    B = x.shape[0]
    hd, H = cfg.hd(), cfg.num_heads
    if cos_sin is None:
        cos_sin = rope_tables(torch.full((B, 1), pos, device=x.device), hd,
                              cfg.rope_theta)
    q, k, v = _project_qkv(p, cfg, x, cos_sin)
    cache_k[:, pos].copy_(k[:, 0])
    cache_v[:, pos].copy_(v[:, 0])
    o = ops.decode_attention(q[:, 0], cache_k[:, :pos + 1],
                             cache_v[:, :pos + 1])          # (B, H, hd) f32
    o = o.to(x.dtype).reshape(B, 1, H * hd)
    return o @ p.wo


def cross_kv(p: Attention, cfg, feats):
    """Cross-attention keys and values of one layer from frontend features
    (B, S, d): ``feats @ wk`` and ``feats @ wv`` without bias or RoPE,
    ``k_norm`` under ``qk_norm``.  Returns k, v (B, S, Kv, hd) in
    ``compute_dtype`` (the features are cast to it first)."""
    B, S, _ = feats.shape
    hd, Kv = cfg.hd(), cfg.num_kv_heads
    feats = feats.to(p.wk.dtype)
    k = (feats @ p.wk).reshape(B, S, Kv, hd)
    v = (feats @ p.wv).reshape(B, S, Kv, hd)
    if cfg.qk_norm:
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return k, v


def cross_attention_step(p: Attention, cfg, x, k, v):
    """One token's cross-attention over precomputed k, v (B, S, Kv, hd):
    ``q = x @ wq`` without bias or RoPE, ``q_norm`` under ``qk_norm``, no
    mask.  x: (B, 1, D) -> (B, 1, D)."""
    B = x.shape[0]
    hd, H = cfg.hd(), cfg.num_heads
    q = (x[:, 0] @ p.wq).reshape(B, H, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
    o = ops.decode_attention(q, k, v)                      # (B, H, hd) f32
    return o.to(x.dtype).reshape(B, 1, H * hd) @ p.wo


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


def mlp(p: MLP, cfg, x):
    if cfg.mlp_act == "swiglu":
        h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    else:
        h = F.gelu(x @ p.w_up, approximate="tanh")    # jax.nn.gelu's default
    return h @ p.w_down


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


def embed(p: Embed, cfg, tokens):
    return F.embedding(tokens, p.tok)


def unembed(p: Embed, cfg, x):
    x = rms_norm(x, p.norm_f, cfg.norm_eps)
    return x @ (p.tok.T if cfg.tie_embeddings else p.unembed)
