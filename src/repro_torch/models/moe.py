"""Grouped top-k mixture-of-experts FFN of the PyTorch port.

The counterpart of the JAX package's ``models/moe.py``.  Tokens are cut
into ``n_groups`` groups of ``g``; each token picks its top ``k`` experts,
and each expert takes at most ``C = capacity(g)`` choices of a group, in
token-major order (token, then choice).  A choice past its expert's
capacity is dropped: it gets weight 0.

The reference dispatches with a one-hot ``(g, E*C)`` matrix and runs every
expert over its whole capacity buffer.  Here each expert's products run
only on the rows it was given (:func:`moe_ffn`), and an expert that got no
row is skipped: an empty slot is a zero row, which neither activation
moves off zero, so the sums are the reference's up to their order.  The
reference's semantics are kept where a port could silently differ:

* Ties in the top-k keep the lower expert index first, as
  ``jax.lax.top_k`` does (a stable descending sort; router logits in a
  bfloat16 model tie often).
* The renormalized weight multiplies an expert's input *and* its output
  (the reference's dispatch matrix carries the weight and does the
  combine too): ``y = sum_k w_k * f_e(w_k * x)``.
* The weight is cast to ``x``'s dtype before either product; the combine
  sums in float32 and casts to ``x``'s dtype.

The same function serves decode (``n_groups=1``) and the full-sequence
forward at (B, T) under autograd: the routing weights of the kept rows
carry the router's gradient, as the reference's dispatch matrix does.
Each call reads the per-expert row counts back to the host once (one
sync a layer); a fake trace, which has no counts to read, gives each
expert the reference's static dispatch's rows (:func:`_static_rows`).
:func:`aux_load_balance_loss` is the reference's Switch-style auxiliary
loss.

Sharded (DTensor activations), the dispatch is data-dependent and reads
row counts on the host, which no DTensor strategy covers, so it runs in
``local_map`` (:func:`_moe_sharded`): the tokens are gathered, every rank
routes all of them (groups are whole and routing is deterministic, so
every rank routes alike), and each rank runs the experts it holds (EP:
the banks split on E over ``model`` under TP) on its share of the tokens
(split over the mesh dims that do not split the experts); the float32
sums are a Partial over the mesh, reduced into the residual's layout.
The port has no (n, g, E*C) dispatch tensor or (n, E, C, D) expert
buffers, so the reference's ``dispatch``, ``experts_flat`` and
``experts`` hooks have no site here.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models import common


class MoE(nn.Module):
    """router (d, E); w_gate / w_up (E, d, f) and w_down (E, f, d) (GELU:
    no w_gate), all in ``compute_dtype``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        dt = common.dtype(cfg.compute_dtype)
        self.router = common.param((d, E), dt, device)
        if cfg.mlp_act == "swiglu":
            self.w_gate = common.param((E, d, f), dt, device)
        self.w_up = common.param((E, d, f), dt, device)
        self.w_down = common.param((E, f, d), dt, device)


def capacity(g: int, cfg) -> int:
    """Slots per expert in a group of ``g`` tokens (the reference's
    expression, in its order)."""
    c = int(g * cfg.experts_per_token / cfg.num_experts
            * cfg.moe_capacity_factor)
    return max(c, cfg.experts_per_token)


def group_count(n_tokens: int, n_groups: Optional[int] = None) -> int:
    """The reference's group count: ``n_groups`` (default one group per
    512 tokens), lowered until it divides the token count."""
    n_groups = n_groups or max(1, n_tokens // 512)
    while n_tokens % n_groups:
        n_groups -= 1
    return n_groups


class Routing(NamedTuple):
    """Each token's choices, (N, k) with N = B * T, best first."""

    experts: torch.Tensor   # int64 expert ids
    weight: torch.Tensor    # float32 renormalized weights, 0 where dropped
    keep: torch.Tensor      # bool: the choice found a slot


def _router_probs(p: MoE, cfg, x, router=None):
    """Softmax of the router's float32 logits: x (..., D) -> (..., E)."""
    router = common.cast(p.router, cfg) if router is None else router
    with common.projection():
        logits = x @ router
    logits = logits.to(torch.float32)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return probs / probs.sum(dim=-1, keepdim=True)       # jax.nn.softmax


def _top_k(probs, k: int):
    """The k largest probabilities and their experts, best first; ties
    keep the lower expert first, as ``jax.lax.top_k`` does."""
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top_p[..., :k], top_e[..., :k]


def route(p: MoE, cfg, x, n_groups: Optional[int] = None,
          router=None) -> Routing:
    """Top-k routing with per-group capacity.  x: (B, T, D); ``router``
    is the router weight in ``compute_dtype`` (default ``p.router``)."""
    B, T, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    N = B * T
    n = group_count(N, n_groups)
    g = N // n
    probs = _router_probs(p, cfg, x.reshape(N, D), router)
    top_p, top_e = _top_k(probs, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # A choice's slot: how many earlier (token, choice) pairs of its group
    # picked the same expert.
    onehot = F.one_hot(top_e, E).reshape(n, g * k, E)
    pos = ((onehot.cumsum(1) - onehot) * onehot).sum(-1).reshape(N, k)
    keep = pos < capacity(g, cfg)
    return Routing(top_e, torch.where(keep, top_p, 0.0), keep)


def moe_ffn(p: MoE, cfg, x, n_groups: Optional[int] = None, *,
            pol=common.NO_SHARDING):
    """x: (B, T, D) -> (B, T, D).  Decode passes ``n_groups=1``.

    Reads the per-expert row counts back to the host once (one device
    sync a call) to run each routed expert on its rows alone."""
    if isinstance(x, DTensor):
        return _moe_sharded(p, cfg, x, n_groups, pol)
    B, T, D = x.shape
    out = _expert_sums(cfg, x, common.cast(p.router, cfg),
                       p.w_gate if cfg.mlp_act == "swiglu" else None,
                       p.w_up, p.w_down, n_groups=n_groups)
    return out.to(x.dtype).reshape(B, T, D)


def _expert_sums(cfg, x, router, w_gate, w_up, w_down, *, n_groups,
                 e0=0, tokens=None):
    """The combine's float32 sums (B * T, D) over x (B, T, D), routed by
    ``router`` (in ``compute_dtype``), of the experts ``e0 + j`` held in
    the banks ``w_*[j]`` (all E by default; each routed expert's weights
    cast at its use), for the tokens in the range ``tokens`` (all by
    default; the other rows stay 0)."""
    B, T, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    r = route(None, cfg, x, n_groups, router)
    # Kept pairs sorted by expert (stable: token-major within one), the
    # dropped ones last, under the id E.
    mine = r.keep
    if e0 or w_up.shape[0] != E:
        mine = mine & (r.experts >= e0) & (r.experts < e0 + w_up.shape[0])
    if tokens is not None:
        tok_id = torch.arange(B * T, device=x.device)[:, None]
        mine = mine & (tok_id >= tokens[0]) & (tok_id < tokens[1])
    ids = torch.where(mine, r.experts, E).reshape(-1)
    order = torch.argsort(ids, stable=True)
    rows = order // k
    wts = r.weight.reshape(-1)[order].to(x.dtype)[:, None]
    xf = x.reshape(-1, D)
    out = torch.zeros((B * T, D), dtype=torch.float32, device=x.device)
    if is_fake(ids):
        n_rows = _static_rows(cfg, B * T, n_groups, tokens)
        picks = [(e, rows.new_zeros(n_rows), wts.new_zeros((n_rows, 1)))
                 for e in range(e0, e0 + w_up.shape[0])]
    else:
        counts = torch.bincount(ids, minlength=E + 1).tolist()
        picks, start = [], 0
        for e, c in enumerate(counts[:E]):
            if c:
                picks.append((e, rows[start:start + c], wts[start:start + c]))
            start += c
    for e, tok, w in picks:
        xe = xf[tok] * w
        up = common.cast(w_up[e - e0], cfg)
        if cfg.mlp_act == "swiglu":
            h = F.silu(xe @ common.cast(w_gate[e - e0], cfg)) * (xe @ up)
        else:
            h = F.gelu(xe @ up, approximate="tanh")
        ye = h @ common.cast(w_down[e - e0], cfg)
        out.index_put_((tok,), ye.to(torch.float32)
                       * w.to(torch.float32), accumulate=True)
    return out


def _static_rows(cfg, n_tokens: int, n_groups, tokens) -> int:
    """Rows each expert takes in a fake trace (``FakeTensorMode``, the dry
    run), where the routed counts are data and cannot be read: the
    reference's static dispatch, ``capacity(g)`` slots a group times the
    groups (no more than the tokens: an expert takes a token once), of
    which the ``tokens`` range holds its share.  ``analytic._moe_flops``
    counts the same slots."""
    n = group_count(n_tokens, n_groups)
    slots = min(capacity(n_tokens // n, cfg) * n, n_tokens)
    share = n_tokens if tokens is None else tokens[1] - tokens[0]
    return -(-slots * share // n_tokens)


def _moe_sharded(p: MoE, cfg, x, n_groups, pol):
    """:func:`moe_ffn` on a DTensor ``x``, in ``local_map`` (module
    docstring): returns (B, T, D) in ``x``'s layout, through
    ``pol.resid``."""
    mesh = x.device_mesh
    B, T, D = x.shape
    swiglu = cfg.mlp_act == "swiglu"
    banks = [pol.weight(p.w_gate)] if swiglu else []
    banks += [pol.weight(p.w_up), pol.weight(p.w_down)]
    router = common.cast(p.router, cfg, pol)
    rep = (Replicate(),) * mesh.ndim
    part = (Partial(),) * mesh.ndim
    # Mesh dims that split the experts (on E) and those that split tokens.
    ep = [isinstance(pl, Shard) and pl.dim == 0 for pl in banks[0].placements]
    coord = mesh.get_coordinate()
    tok_dims = [i for i in range(mesh.ndim) if not ep[i]]
    n_tok = math.prod(mesh.size(i) for i in tok_dims)
    idx = 0
    for i in tok_dims:
        idx = idx * mesh.size(i) + coord[i]
    e_loc = cfg.num_experts // math.prod(
        mesh.size(i) for i in range(mesh.ndim) if ep[i])
    e_idx = 0
    for i in range(mesh.ndim):
        if ep[i]:
            e_idx = e_idx * mesh.size(i) + coord[i]
    N = B * T
    bank_pl = tuple(banks[0].placements)     # the rules place all alike
    bank_grad = tuple(pl if ep[i] else Partial()
                      for i, pl in enumerate(bank_pl))

    def local(xl, rl, *bl):
        wg, wu, wd = (bl if swiglu else (None,) + bl)
        return _expert_sums(cfg, xl, rl, wg, wu, wd, n_groups=n_groups,
                            e0=e_idx * e_loc,
                            tokens=(N * idx // n_tok,
                                    N * (idx + 1) // n_tok))

    fn = local_map(local, out_placements=list(part),
                   in_placements=(rep, rep) + (bank_pl,) * len(banks),
                   in_grad_placements=(part, part) + (bank_grad,)
                   * len(banks),
                   device_mesh=mesh, redistribute_inputs=True)
    out = fn(x, router, *banks)
    out = out.reshape(B, T, D).redistribute(mesh, x.placements)
    return pol.resid(out.to(x.dtype))


def aux_load_balance_loss(p: MoE, cfg, x):
    """Switch-style load-balance auxiliary loss over x (B, T, D): E times
    the sum over experts of (fraction of the top-k choices routed to the
    expert) x (its mean router probability), each averaged over the
    batch.  The fractions carry no gradient; the probabilities do."""
    probs = _router_probs(p, cfg, x)                      # (B, T, E)
    E, k = cfg.num_experts, cfg.experts_per_token
    top_e = _top_k(probs, k)[1]
    frac = F.one_hot(top_e, E).sum(dim=(-3, -2)).to(torch.float32) / (
        probs.shape[-2] * k)
    mean_p = probs.mean(dim=-2)
    return E * torch.sum(frac.reshape(-1, E).mean(0)
                         * mean_p.reshape(-1, E).mean(0))
