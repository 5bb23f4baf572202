"""Adam and SGD with the reference's exact updates, over dicts of tensors.

Port of ``repro.training.optim``: the same bias correction, the same
order of operations, with ``eps`` added outside the square root, weight
decay inside the learning-rate product, global-norm clipping, and
``cosine_schedule``.  State is a dict of tensors of the same structure as
the params, kept on their device; the step count is a tensor too, so an
update needs no host sync, and a schedule is a function of that tensor.

:meth:`Adam.update` returns new tensors (REINFORCE's epoch, eager or
inside a CUDA graph); :meth:`Adam.update_` writes the same values into
the params and moments in place (the LM train steps, where JAX donates
the buffers).

dtypes follow the reference's promotion: its bias corrections are float32
arrays, so a bfloat16 parameter comes out float32 (:func:`_wide`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

Tensors = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Tensors          # first moment
    nu: Tensors          # second moment


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` promoted as JAX promotes it against a float32 array: half
    types become float32, float32 and float64 stay (a no-op)."""
    return t if t.dtype in (torch.float32, torch.float64) else t.float()


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam / AdamW with bias correction.  ``lr`` is a float or a function
    of the step tensor (:func:`cosine_schedule`); ``weight_decay`` is added
    to the update inside the lr product; ``clip_norm`` clips by the global
    norm first."""

    lr: Any = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = None

    def init(self, params: Tensors) -> OptState:
        dev = next(iter(params.values())).device
        return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                        {k: torch.zeros_like(p) for k, p in params.items()},
                        {k: torch.zeros_like(p) for k, p in params.items()})

    def _begin(self, grads: Tensors, state: OptState):
        """The step, lr, bias corrections and (clipped) gradients."""
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        if self.clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp_max(self.clip_norm / (gnorm + 1e-9), 1.0)
            grads = {k: g * scale for k, g in grads.items()}
        t = step.to(torch.float32)
        return step, lr, 1 - self.b1 ** t, 1 - self.b2 ** t, grads

    def _leaf(self, p, m, v, g, lr, bc1, bc2):
        """One tensor's (new param, mu, nu)."""
        m = self.b1 * m + (1 - self.b1) * g
        v = self.b2 * v + (1 - self.b2) * g * g
        upd = (_wide(m) / bc1) / (torch.sqrt(_wide(v) / bc2) + self.eps)
        if self.weight_decay:       # the reference adds 0 * p otherwise
            upd = upd + self.weight_decay * p
        return _wide(p) - lr * upd, m, v

    @torch.no_grad()
    def update(self, grads: Tensors, state: OptState, params: Tensors):
        """Returns (new_params, new_state); inputs are not modified."""
        step, lr, bc1, bc2, grads = self._begin(grads, state)
        new_params, mu, nu = {}, {}, {}
        for k, p in params.items():
            new_params[k], mu[k], nu[k] = self._leaf(
                p, state.mu[k], state.nu[k], grads[k], lr, bc1, bc2)
        return new_params, OptState(step, mu, nu)

    @torch.no_grad()
    def update_(self, grads: Tensors, state: OptState,
                params: Tensors) -> OptState:
        """:meth:`update`'s values written into ``params`` and the moments
        of ``state`` in place, one tensor at a time (so no second copy of
        the weights is held); returns the state with the new step.  The
        params, moments and gradients must share the dtype the update
        gives (float32 master weights)."""
        step, lr, bc1, bc2, grads = self._begin(grads, state)
        for k, p in params.items():
            new, m, v = self._leaf(p, state.mu[k], state.nu[k], grads[k],
                                   lr, bc1, bc2)
            if new.dtype != p.dtype or m.dtype != state.mu[k].dtype:
                raise TypeError(f"{k}: an in-place update needs params, "
                                f"moments and gradients of one dtype, got "
                                f"{p.dtype} / {state.mu[k].dtype} / "
                                f"{grads[k].dtype}")
            p.copy_(new)
            state.mu[k].copy_(m)
            state.nu[k].copy_(v)
        return OptState(step, state.mu, state.nu)


@dataclasses.dataclass(frozen=True)
class SGD:
    """SGD with optional momentum; ``lr`` as for :class:`Adam`."""

    lr: Any = 1e-2
    momentum: float = 0.0

    def init(self, params: Tensors) -> OptState:
        dev = next(iter(params.values())).device
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                        zeros, zeros)

    @torch.no_grad()
    def update(self, grads: Tensors, state: OptState, params: Tensors):
        step = state.step + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        mu = {k: self.momentum * state.mu[k] + g for k, g in grads.items()}
        new_params = {k: p - lr * mu[k] for k, p in params.items()}
        return new_params, OptState(step, mu, state.nu)


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, summed in sorted-key
    order (the order of the reference's pytree leaves)."""
    return torch.sqrt(sum(torch.sum(torch.square(tensors[k]))
                          for k in sorted(tensors)))


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    floor: float = 0.0) -> Callable:
    """Linear warm-up over ``warmup`` steps, then a cosine from ``base_lr``
    to ``floor`` at ``total``: a function of the step tensor, returning a
    float32 tensor (the reference's schedule)."""
    def fn(step):
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = floor + (base_lr - floor) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
        return torch.where(step < warmup, warm, cos)
    return fn
