"""Plateau-op primitives of the cost model: the hard implementation.

The model core (:mod:`repro_torch.costmodel.maestro`) routes every
non-smooth op -- ``ceil``-division tile counts, ``floor``/``clip`` PE
factorizations, hard ``min``/``max`` bottlenecks and branch gates --
through one :class:`Primitives` record, so a smooth implementation can
share the same core later.  Only :data:`HARD`, the exact ops, exists here.
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
    blend: Callable       # where(g, a, b) with g a {0,1} gate
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
