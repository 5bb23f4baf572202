"""Adam with the reference's exact update, over dicts of tensors.

Port of ``repro.training.optim.Adam``: the same bias correction, the same
order of operations, with ``eps`` added outside the square root.  State is
a dict of tensors of the same structure as the params, kept on their
device; the step count is a tensor too, so an update needs no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

Tensors = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Tensors          # first moment
    nu: Tensors          # second moment


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam with bias correction and optional global-norm clipping (the
    reference's defaults; its weight decay and schedules have no caller in
    the port)."""

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip_norm: Optional[float] = None

    def init(self, params: Tensors) -> OptState:
        dev = next(iter(params.values())).device
        return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                        {k: torch.zeros_like(p) for k, p in params.items()},
                        {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Tensors, state: OptState, params: Tensors):
        """Returns (new_params, new_state); inputs are not modified."""
        step = state.step + 1
        if self.clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp_max(self.clip_norm / (gnorm + 1e-9), 1.0)
            grads = {k: g * scale for k, g in grads.items()}
        mu = {k: self.b1 * state.mu[k] + (1 - self.b1) * g
              for k, g in grads.items()}
        nu = {k: self.b2 * state.nu[k] + (1 - self.b2) * g * g
              for k, g in grads.items()}
        t = step.to(torch.float32)
        bc1 = 1 - self.b1 ** t
        bc2 = 1 - self.b2 ** t
        new_params = {
            k: p - self.lr * ((mu[k] / bc1)
                              / (torch.sqrt(nu[k] / bc2) + self.eps))
            for k, p in params.items()}
        return new_params, OptState(step, mu, nu)


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, summed in sorted-key
    order (the order of the reference's pytree leaves)."""
    return torch.sqrt(sum(torch.sum(torch.square(tensors[k]))
                          for k in sorted(tensors)))
