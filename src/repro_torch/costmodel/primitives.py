"""Plateau-op primitives of the cost model: a hard and a soft implementation.

Port of ``repro.costmodel.primitives``.  The model core
(:mod:`repro_torch.costmodel.maestro`) routes every non-smooth op --
``ceil``-division tile counts, ``floor``/``clip`` PE factorizations, hard
``min``/``max`` bottlenecks and branch gates -- through one
:class:`Primitives` record with two implementations:

  * :data:`HARD` -- the exact ops, the plain version of the CUDA cost
    kernel;
  * :func:`soft` -- temperature-controlled smooth surrogates whose
    gradient is finite and non-zero everywhere, and which converge to the
    hard ops as ``tau -> 0`` (the relaxed engine descends them).

Soft surrogate cheat-sheet (``tau`` is the shared temperature):

  ceil(x)        -> ``floor(x) + step(frac(x))`` with a normalized sigmoid
                    step, exact at integer inputs at every temperature.
  max(a, b)      -> ``b + t*softplus((a-b)/t)`` (>= hard max).
  min(a, b)      -> ``b - t*softplus((b-a)/t)`` (<= hard min).
  clip(x, lo, hi)-> smooth max then smooth min.
  max(a, b, c)   -> p-norm smooth maximum with ``p = 12/tau``.
  1{x == v}      -> ``sigmoid((1/2 - |x - v|) / w)`` gate.
  where(g, a, b) -> convex blend ``g*a + (1-g)*b``.

``softplus`` is written as the reference's ``logaddexp(x, 0)``:
``torch.nn.functional.softplus`` turns into the identity above its
threshold, which the reference's does not.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Primitives(NamedTuple):
    """The plateau-op interface of the model core."""

    name: str
    ceil_div: Callable    # ceil(a / max(b, 1))       -- tile / step counts
    floor_div: Callable   # floor(a / b)              -- PE factorization
    clip: Callable        # clip(x, lo, hi)           -- parallel-width bounds
    maximum: Callable     # max(a, b)                 -- guards, bottlenecks
    minimum: Callable     # min(a, b)                 -- kt_eff coverage caps
    blend: Callable       # where(g, a, b) with g a {0,1}/[0,1] gate
    clip01: Callable      # clip(x, 0, 1)             -- L2 spill fractions
    max3: Callable        # max(a, b, c)              -- latency bottleneck
    eq_gate: Callable     # 1{x == v} as f32          -- is_dw / dataflow


def _clip(x, lo, hi):
    # jnp.clip semantics: minimum(maximum(x, lo), hi); bounds may be tensors.
    return torch.clamp_max(torch.clamp_min(x, lo), hi)


def hard() -> Primitives:
    """The exact plateau ops."""
    return Primitives(
        name="hard",
        ceil_div=lambda a, b: torch.ceil(a / torch.clamp_min(b, 1.0)),
        floor_div=lambda a, b: torch.floor(a / b),
        clip=_clip,
        maximum=torch.clamp_min,
        minimum=torch.clamp_max,
        blend=lambda g, a, b: torch.where(g > 0, a, b),
        clip01=lambda x: _clip(x, 0.0, 1.0),
        max3=lambda a, b, c: torch.maximum(torch.maximum(a, b), c),
        eq_gate=lambda x, v: (x == v).to(torch.float32),
    )


HARD = hard()

# Floor guard for ceil-division outputs on the soft path: hard ceil-division
# never returns < 1, and letting the relaxation drift toward 0 would collapse
# compute terms to ~0 and fabricate gradient toward meaningless regions.
_GUARD_T = 0.02


def _f32(x):
    """``x`` as a float32 tensor (a tensor keeps its device and graph)."""
    return torch.as_tensor(x, dtype=torch.float32)


def softplus(x):
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)``, the reference's form
    (the gradient is ``sigmoid(x)`` everywhere)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def soft_ceil(x, tau):
    """Smooth, monotone staircase converging to ``ceil`` as ``tau -> 0``.

    ``floor(x) + step(frac(x))`` where ``step`` is a sigmoid normalized to
    hit exactly 0 at ``frac = 0`` and 1 at ``frac = 1``: continuous across
    cells and exact at integer inputs.  The step's center tracks ``tau``
    toward the left cell edge, matching ceil's jump-at-integer semantics in
    the sharp limit.
    """
    tau = _f32(tau)
    c = torch.clamp(0.5 * tau, 0.02, 0.5)          # step center
    w = torch.clamp(0.25 * tau, 0.005, 0.25)       # step width
    f = torch.floor(x)
    r = x - f
    s = torch.sigmoid((r - c) / w)
    s0 = torch.sigmoid(-c / w)
    s1 = torch.sigmoid((1.0 - c) / w)
    return f + (s - s0) / (s1 - s0)


def soft_floor(x, tau):
    """Smooth floor: the mirrored staircase, ``-soft_ceil(-x, tau)``."""
    return -soft_ceil(-x, tau)


def smooth_max(a, b, t):
    """``>=`` hard max, smooth, with softplus transition of width ``t``."""
    return b + t * softplus((a - b) / t)


def smooth_min(a, b, t):
    """``<=`` hard min, smooth, with softplus transition of width ``t``."""
    return b - t * softplus((b - a) / t)


def smooth_clip(x, lo, hi, t):
    return smooth_min(smooth_max(x, lo, t), hi, t)


def smooth_amax(x, p, dim=-1):
    """Scale-invariant smooth maximum of positives along ``dim``.

    The p-norm ``(sum x^p)^(1/p)`` overshoots the hard max by at most
    ``n**(1/p)``.  The normalization by the hard max is detached, as the
    reference stops its gradient: it only keeps ``x**p`` in f32 range.
    """
    m = torch.clamp_min(torch.amax(x, dim=dim, keepdim=True), 1e-30).detach()
    s = torch.sum((x / m) ** p, dim=dim)
    return torch.squeeze(m, dim) * s ** (1.0 / p)


def soft(tau) -> Primitives:
    """Temperature-``tau`` smooth surrogates of every plateau op.

    ``tau`` may be a 0-d tensor on the device (the relaxed engine anneals
    it without a host read).  ``tau ~ 1`` gives a heavily smoothed
    landscape; ``tau -> 0`` recovers the hard ops.
    """
    tau = _f32(tau)
    t_guard = torch.clamp(0.1 * tau, 0.01, 0.1)    # lower-bound guards
    t_clip = torch.clamp(0.25 * tau, 0.01, 0.25)   # spill-fraction clipping
    t_gate = 0.05 * torch.clamp(tau, 0.1, 1.0)     # indicator gates (sharp)
    p = 12.0 / torch.clamp(tau, 1e-3, 1.0)         # latency-bottleneck norm

    def ceil_div(a, b):
        raw = soft_ceil(a / smooth_max(b, 1.0, t_guard), tau)
        return smooth_max(raw, 1.0, _GUARD_T)

    def max3(a, b, c):
        return smooth_amax(torch.stack(
            torch.broadcast_tensors(a, b, c), dim=-1), p)

    return Primitives(
        name="soft",
        ceil_div=ceil_div,
        floor_div=lambda a, b: soft_floor(a / b, tau),
        clip=lambda x, lo, hi: smooth_clip(x, lo, hi, t_guard),
        maximum=lambda a, b: smooth_max(a, b, t_guard),
        minimum=lambda a, b: smooth_min(a, b, t_guard),
        blend=lambda g, a, b: g * a + (1.0 - g) * b,
        clip01=lambda x: smooth_clip(x, 0.0, 1.0, t_clip),
        max3=max3,
        eq_gate=lambda x, v: torch.sigmoid(
            (0.5 - torch.abs(_f32(x) - v)) / t_gate),
    )
