"""Policy networks for the ConfuciuX agent (SIII-A2, Table IX).

Port of ``repro.core.policy``.  The paper's policy is an RNN with one
LSTM(128) hidden layer; an MLP variant exists for the Table IX ablation.
Heads: one L-way categorical per action (PE level, Buffer level) plus an
optional 3-way dataflow head for the MIX agent (SIV-D).

The parameters keep the reference's layout and names (``lstm.wx (I, 4H)``,
``lstm.wh (H, 4H)``, ``lstm.b (4H,)``, gate order i, f, g, o, and
``head_pe.w (H, L)`` ...), so :func:`params_from_jax` carries the
reference's weights across one to one.  The actor-critic baselines add a
linear critic, ``head_v.w (H, 1)`` and ``head_v.b (1,)`` (``critic=True``).
The LSTM step goes through
:func:`repro_torch.kernels.ops.lstm_step`: the CUDA kernel on the card,
the plain version on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops as kops

HIDDEN = 128  # the paper's LSTM size


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    obs_dim: int = 10
    hidden: int = HIDDEN
    levels: int = 12          # L action levels
    mix: bool = False         # add the 3-way dataflow head
    kind: str = "rnn"         # "rnn" (paper) | "mlp" (Table IX ablation)

    @property
    def n_heads(self) -> int:
        return 3 if self.mix else 2


class LSTMState(NamedTuple):
    h: torch.Tensor
    c: torch.Tensor


def _param_shapes(cfg: PolicyConfig, critic: bool = False):
    """{group: {name: shape}} in the reference's layout."""
    H, I, L = cfg.hidden, cfg.obs_dim, cfg.levels
    shapes = {"head_pe": {"w": (H, L), "b": (L,)},
              "head_kt": {"w": (H, L), "b": (L,)}}
    if cfg.mix:
        shapes["head_df"] = {"w": (H, 3), "b": (3,)}
    if cfg.kind == "rnn":
        shapes["lstm"] = {"wx": (I, 4 * H), "wh": (H, 4 * H), "b": (4 * H,)}
    elif cfg.kind == "mlp":
        shapes["mlp"] = {"w1": (I, H), "b1": (H,), "w2": (H, H), "b2": (H,)}
    else:
        raise ValueError(f"unknown policy kind {cfg.kind!r}")
    if critic:
        shapes["head_v"] = {"w": (H, 1), "b": (1,)}
    return shapes


class Policy(nn.Module):
    """The policy's parameters, one ``ParameterDict`` per reference group
    (with the critic's ``head_v`` when ``critic``)."""

    def __init__(self, cfg: PolicyConfig, device="cpu", critic=False):
        super().__init__()
        self.cfg = cfg
        self.critic = critic
        for group, shapes in _param_shapes(cfg, critic).items():
            setattr(self, group, nn.ParameterDict({
                n: nn.Parameter(torch.zeros(s, dtype=torch.float32,
                                            device=device))
                for n, s in shapes.items()}))

    def forward(self, obs, state: LSTMState):
        return step(self, self.cfg, obs, state)


def _glorot(gen, shape, device):
    fan_in, fan_out = shape[0], shape[-1]
    scale = float(np.sqrt(2.0 / (fan_in + fan_out)))
    return torch.randn(shape, generator=gen, device=device) * scale


def init_params(cfg: PolicyConfig, generator: torch.Generator,
                device="cpu", critic=False) -> Policy:
    """A freshly initialized policy: glorot-normal weights, zero biases and
    forget-gate bias 1.0 (standard LSTM initialization).  With ``critic``,
    then the critic's ``head_v.w`` as N(0, 1) x 0.01 and a zero bias, as
    the reference's ``rl_baselines.init_ac_params`` draws them.

    ``generator`` must live on ``device``.
    """
    pol = Policy(cfg, device, critic)
    with torch.no_grad():
        for group, shapes in _param_shapes(cfg).items():
            for name, shape in shapes.items():
                if len(shape) == 2:
                    getattr(pol, group)[name].copy_(
                        _glorot(generator, shape, device))
        if cfg.kind == "rnn":
            H = cfg.hidden
            pol.lstm["b"][H:2 * H] = 1.0
        if critic:
            pol.head_v["w"].copy_(torch.randn(
                (cfg.hidden, 1), generator=generator, device=device) * 0.01)
    return pol


def params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]],
                    cfg: PolicyConfig, device="cpu") -> Policy:
    """A policy holding the given reference params (a nested dict of numpy
    arrays, as ``repro.core.policy.init_params`` lays them out; with the
    critic's ``head_v`` where the tree has it, as
    ``repro.core.rl_baselines.init_ac_params`` adds it)."""
    critic = "head_v" in tree
    pol = Policy(cfg, device, critic)
    shapes = _param_shapes(cfg, critic)
    if set(tree) != set(shapes):
        raise ValueError(f"param groups {sorted(tree)} != {sorted(shapes)}")
    with torch.no_grad():
        for group, names in shapes.items():
            for name, shape in names.items():
                val = np.array(tree[group][name], np.float32)  # writable
                if val.shape != shape:
                    raise ValueError(f"{group}.{name}: shape {val.shape}, "
                                     f"expected {shape}")
                getattr(pol, group)[name].copy_(torch.from_numpy(val))
    return pol


def init_state(cfg: PolicyConfig, batch=(), device="cpu") -> LSTMState:
    shape = (*batch, cfg.hidden)
    return LSTMState(torch.zeros(shape, device=device),
                     torch.zeros(shape, device=device))


def step(params: Policy, cfg: PolicyConfig, obs, state: LSTMState):
    """One policy step.  obs: (..., obs_dim).  Returns (logits_tuple, state').

    The MLP variant ignores (and passes through) the recurrent state.
    """
    if cfg.kind == "rnn":
        lp = params.lstm
        squeeze = obs.dim() == 1
        x = obs[None, :] if squeeze else obs
        h = state.h[None, :] if squeeze else state.h
        c = state.c[None, :] if squeeze else state.c
        h2, c2 = kops.lstm_step(x, h, c, lp["wx"], lp["wh"], lp["b"])
        if squeeze:
            h2, c2 = h2[0], c2[0]
        feat, new_state = h2, LSTMState(h2, c2)
    else:
        mp = params.mlp
        z = torch.tanh(obs @ mp["w1"] + mp["b1"])
        feat = torch.tanh(z @ mp["w2"] + mp["b2"])
        new_state = state

    logits = [feat @ params.head_pe["w"] + params.head_pe["b"],
              feat @ params.head_kt["w"] + params.head_kt["b"]]
    if cfg.mix:
        logits.append(feat @ params.head_df["w"] + params.head_df["b"])
    return tuple(logits), new_state


def log_prob_entropy(logits, a):
    """(log_prob of action ``a``, entropy) of a categorical over the last
    axis of ``logits``."""
    logp = torch.log_softmax(logits, dim=-1)
    lp = torch.gather(logp, -1, a[..., None])[..., 0]
    ent = -torch.sum(torch.exp(logp) * logp, dim=-1)
    return lp, ent


def sample_action(generator: Optional[torch.Generator], logits):
    """Sample one categorical action; returns (action, log_prob, entropy).

    Gumbel-max over ``logits``, drawn from ``generator`` on the logits'
    device, so the draw needs no host sync.
    """
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    a = torch.argmax(logits.detach() + gumbel, dim=-1)
    lp, ent = log_prob_entropy(logits, a)
    return a, lp, ent
