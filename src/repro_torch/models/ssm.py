"""Mamba2 decode of the PyTorch port: parameters, cache and one-token step.

The decode half of the JAX package's ``models/ssm.py``.  Per head h the
recurrence is

    S_t = a_t * S_{t-1} + dt_t * (B_t (x) x_t),   a_t = exp(dt_t * A_h)
    y_t = C_t . S_t + D_h * x_t

on a persistent (H, P, S) state, after a depth-wise causal conv over the
last ``CONV_WIDTH`` inputs.  As in the reference:

* The cache is float32 whatever the model's ``compute_dtype``, as the
  reference's cache is (:func:`init_mamba_cache`).  In a
  bfloat16 model the conv input is promoted by the concatenation with
  the float32 tail, so the conv, the scan and ``y`` run in float32, and
  ``y`` is cast back to the model's dtype before the gate.
* ``in_proj``, ``conv_w``, ``conv_b`` and ``out_proj`` are applied in
  ``compute_dtype`` (stored in it here); ``A_log``, ``D``, ``dt_bias`` and
  ``gate_norm`` are read as float32.
* One B/C group is shared by all heads.

The chunked forward (``ssd_chunked`` / ``mamba_forward``) belongs to
training and prefill and is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common

CONV_WIDTH = 4


def dims(cfg) -> Tuple[int, int, int, int]:
    """(d_inner, n_heads, head_dim P, state S)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    return d_inner, d_inner // P, P, cfg.ssm_state


class Mamba(nn.Module):
    """in_proj (d, 2 d_inner + 2S + H), conv_w (CONV_WIDTH, d_inner + 2S),
    conv_b, out_proj (d_inner, d) in ``compute_dtype``; A_log, D, dt_bias
    (H,) and gate_norm (d_inner,) in float32."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d = cfg.d_model
        d_inner, H, P, S = dims(cfg)
        conv_ch = d_inner + 2 * S
        dt = common.dtype(cfg.compute_dtype)
        f32 = torch.float32
        self.in_proj = common.param((d, 2 * d_inner + 2 * S + H), dt, device)
        self.conv_w = common.param((CONV_WIDTH, conv_ch), dt, device)
        self.conv_b = common.param((conv_ch,), dt, device)
        self.A_log = common.param((H,), f32, device)
        self.D = common.param((H,), f32, device)
        self.dt_bias = common.param((H,), f32, device)
        self.gate_norm = common.param((d_inner,), f32, device)
        self.out_proj = common.param((d_inner, d), dt, device)


def init_fixed(name: str, p: torch.Tensor) -> bool:
    """Fill ``p`` if the reference initializes the Mamba leaf ``name`` to
    fixed values (A_log = log(linspace(1, 16, H)), D = 1, dt_bias =
    log(expm1(0.01)), gate_norm = 1, conv_b = 0); say whether it did."""
    if name == "A_log":
        H = p.numel()
        lin = torch.linspace(1.0, 16.0, H, dtype=torch.float64)
        p.copy_(torch.log(lin))
    elif name == "dt_bias":
        p.copy_(torch.log(torch.expm1(torch.tensor(0.01))).expand_as(p))
    elif name in ("D", "gate_norm"):
        p.fill_(1.0)
    elif name == "conv_b":
        p.zero_()
    else:
        return False
    return True


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, CONV_WIDTH - 1, conv_ch) trailing conv inputs
    ssm: torch.Tensor    # (B, H, P, S) recurrent state


def init_mamba_cache(cfg, batch: int, device="cpu") -> MambaCache:
    """Zero conv tail and state, both float32 in every model, because the
    reference's cache is float32 and a bfloat16 model's step is promoted
    by it."""
    d_inner, H, P, S = dims(cfg)
    conv_ch = d_inner + 2 * S
    f32 = torch.float32
    return MambaCache(
        conv=torch.zeros((batch, CONV_WIDTH - 1, conv_ch), dtype=f32,
                         device=device),
        ssm=torch.zeros((batch, H, P, S), dtype=f32, device=device))


@torch.no_grad()
def mamba_step(p: Mamba, cfg, x, cache: MambaCache):
    """One-token Mamba2 step.  x: (B, 1, D) -> (B, 1, D) and the cache,
    whose tensors are updated in place."""
    B = x.shape[0]
    d_inner, H, P, S = dims(cfg)
    z, xbc, dt = torch.split(x[:, 0] @ p.in_proj,
                             [d_inner, d_inner + 2 * S, H], dim=-1)
    # Causal conv over (stored tail + current input); the float32 tail
    # promotes the rest of the step.
    hist = torch.cat([cache.conv, xbc[:, None, :]], dim=1)
    xbc_c = F.silu((hist * p.conv_w).sum(dim=1) + p.conv_b)
    xs, Bm, Cm = torch.split(xbc_c, [d_inner, S, S], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias)
    a = torch.exp(dt * -torch.exp(p.A_log))                   # (B, H)
    xh = xs.reshape(B, H, P).to(torch.float32)
    dBx = ((dt[:, :, None] * xh)[..., None]
           * Bm.to(torch.float32)[:, None, None, :])          # (B, H, P, S)
    ssm = cache.ssm * a[:, :, None, None] + dBx
    y = (ssm @ Cm.to(torch.float32)[:, None, :, None])[..., 0]  # (B, H, P)
    y = y + p.D[None, :, None] * xh
    y = y.reshape(B, d_inner).to(x.dtype)
    y = common.rms_norm(y * F.silu(z), p.gate_norm, cfg.norm_eps)
    cache.conv.copy_(hist[:, 1:])
    cache.ssm.copy_(ssm)
    return (y @ p.out_proj)[:, None, :], cache
