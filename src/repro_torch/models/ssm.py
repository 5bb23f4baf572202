"""Mamba2 blocks of the PyTorch port: parameters, the chunked SSD forward,
the cache and the one-token step.

The counterpart of the JAX package's ``models/ssm.py``.  Per head h the
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

Training and prefill run the chunked algorithm (:func:`ssd_chunked`, the
SSD paper's "quadratic within a chunk, linear across chunks"): within a
chunk of Q tokens a masked decay-weighted product, across chunks a short
recurrence over the boundary states, all in float32, then the ``D``
skip.  Q is ``cfg.ssm_chunk``, lowered until it divides T, as in the
reference.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

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


def _causal_conv(x, w, b):
    """Depth-wise causal conv.  x: (B, T, C); w: (W, C); b: (C,)."""
    W, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + T, :] * w[i][None, None, :] for i in range(W))
    return out + b[None, None, :]


def _split_proj(cfg, zxbcdt):
    """in_proj's output -> z (d_inner), xBC (d_inner + 2S), dt (H)."""
    d_inner, H, P, S = dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * S, H], dim=-1)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """x: (B, T, H, P), dt: (B, T, H), A: (H,), Bm / Cm: (B, T, S) ->
    (B, T, H, P), the reference's chunked scan in its order of operations
    (the chunk lowered until it divides T)."""
    B_, T, H, P = x.shape
    S = Bm.shape[-1]
    Q = min(chunk, T)
    while T % Q:
        Q -= 1
    nc = T // Q
    xc = x.reshape(B_, nc, Q, H, P)
    dtc = dt.reshape(B_, nc, Q, H)
    Bc = Bm.reshape(B_, nc, Q, S)
    Cc = Cm.reshape(B_, nc, Q, S)

    a = dtc * A[None, None, None, :]                  # (B,nc,Q,H) log decay
    cum = torch.cumsum(a, dim=2)

    # Within a chunk: masked decay-weighted scores.
    CB = torch.einsum("bnqs,bnks->bnqk", Cc, Bc)      # (B,nc,Q,Q)
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    Wt = CB[..., None] * decay * dtc[:, :, None, :, :]  # (B,nc,t,s,H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    Wt = torch.where(mask[None, None, :, :, None], Wt, 0.0)
    y_intra = torch.einsum("bnqkh,bnkhp->bnqhp", Wt, xc)

    # Across chunks: the boundary states.
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,Q,H)
    Sc = torch.einsum("bnqh,bnqs,bnqhp->bnhps", decay_to_end * dtc, Bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])         # (B,nc,H)
    state = torch.zeros((B_, H, P, S), dtype=x.dtype, device=x.device)
    entering = []                                     # state entering chunk
    for n in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, n, :, None, None] + Sc[:, n]
    Sprev = torch.stack(entering, dim=1)              # (B,nc,H,P,S)
    y_inter = torch.einsum("bnqs,bnhps,bnqh->bnqhp", Cc, Sprev,
                           torch.exp(cum))
    return (y_intra + y_inter).reshape(B_, T, H, P)


def mamba_forward(p: Mamba, cfg, x, *, pol=common.NO_SHARDING):
    """Full-sequence Mamba2 block.  x: (B, T, D) -> (B, T, D).

    Sharded (DTensor activations), the in-projection's output is made
    whole on every rank before it is split (its three parts are not
    multiples of a shard), the conv runs on the batch shards, and the
    SSD scan (:func:`ssd_chunked`, sequential in T) runs in ``local_map``
    on each rank's batch rows and heads (``pol.ssm_x``: heads on
    ``model`` when they divide)."""
    B, T, D = x.shape
    d_inner, H, P, S = dims(cfg)
    c = lambda w: common.cast(w, cfg, pol)
    zxbcdt = common._dense(x, c(p.in_proj))
    if isinstance(zxbcdt, DTensor):
        zxbcdt = _batch_only(zxbcdt)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc = F.silu(_causal_conv(xbc, c(p.conv_w), c(p.conv_b)))
    xs, Bm, Cm = torch.split(xbc, [d_inner, S, S], dim=-1)
    f32 = torch.float32
    dt = F.softplus(dt.to(f32) + pol.weight(p.dt_bias)[None, None, :])
    A = -torch.exp(pol.weight(p.A_log))
    # The SSD chunk scan is sequential in T: the sequence must be complete
    # per device (heads shard over 'model' instead, when divisible).
    xh = pol.ssm_x(xs.reshape(B, T, H, P))
    y = _ssd(xh.to(f32), dt, A, Bm.to(f32), Cm.to(f32), cfg.ssm_chunk)
    y = y + pol.weight(p.D)[None, None, :, None] * xh.to(f32)
    y = y.reshape(B, T, d_inner).to(x.dtype)
    y = common.rms_norm(y * F.silu(z), pol.weight(p.gate_norm),
                        cfg.norm_eps)
    return pol.resid(common._dense(y, c(p.out_proj)))


def _batch_only(x):
    """A DTensor with every mesh dim that does not split its batch dim
    made whole (a Partial sum reduced)."""
    want = tuple(pl if isinstance(pl, Shard) and pl.dim == 0
                 else Replicate() for pl in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def _ssd(x, dt, A, Bm, Cm, chunk):
    """:func:`ssd_chunked`, in ``local_map`` on DTensors: x (B, T, H, P)
    and dt (B, T, H) split on B and H alike, A on H as x's heads, Bm / Cm
    on B; the output as x."""
    if not isinstance(x, DTensor):
        return ssd_chunked(x, dt, A, Bm, Cm, chunk)
    mesh = x.device_mesh
    px = tuple(x.placements)
    if any(isinstance(pl, Shard) and pl.dim not in (0, 2) for pl in px):
        x = _batch_only(x)
        px = tuple(x.placements)
    pdt = px                       # (B, T, H): B on 0, H on 2 as x's
    pA = tuple(Shard(0) if isinstance(pl, Shard) and pl.dim == 2
               else Replicate() for pl in px)
    pB = tuple(pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
               for pl in px)
    # A's gradient on each rank covers its batch rows only, and Bm's and
    # Cm's its heads only: Partial sums over the mesh dims that split
    # those.
    gA = tuple(a if isinstance(a, Shard) else
               Partial() if isinstance(pl, Shard) else Replicate()
               for a, pl in zip(pA, px))
    gB = tuple(Partial() if isinstance(pl, Shard) and pl.dim == 2 else b
               for b, pl in zip(pB, px))
    fn = local_map(functools.partial(ssd_chunked, chunk=chunk),
                   out_placements=list(px),
                   in_placements=(px, pdt, pA, pB, pB),
                   in_grad_placements=(px, pdt, gA, gB, gB),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, dt, A, Bm, Cm)


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


def _step_core(cfg, xbc, dt, conv_w, conv_b, dt_bias, A_log, D, conv, ssm,
               ch_off=0, heads=slice(None), gather=None):
    """The Mamba2 step's arithmetic on one rank's part of the cache (the
    whole cache unsharded), writing that part in place: the conv over the
    tail ``conv`` (B, W - 1, C_l) and channels ``[ch_off, ch_off + C_l)``
    of this step's ``xbc`` (B, C), silu, ``gather`` of the convolved
    channels (whole ones needed for the split into x, B and C), then the
    decay and state update of the heads ``heads`` of state ``ssm`` (B,
    H_l, P, S).  ``conv_w`` / ``conv_b`` are this part's columns; the
    float32 tail promotes the rest of the step.  Returns y (B, H_l, P)
    float32 with its D·x skip."""
    d_inner, H, P, S = dims(cfg)
    f32 = torch.float32
    ch = conv.shape[2]
    hist = torch.cat([conv, xbc[:, None, ch_off:ch_off + ch]], dim=1)
    xbc_c = F.silu((hist * conv_w).sum(dim=1) + conv_b)
    conv.copy_(hist[:, 1:])
    if gather is not None:
        xbc_c = gather(xbc_c)
    xs, Bm, Cm = torch.split(xbc_c, [d_inner, S, S], dim=-1)
    dt = F.softplus(dt.to(f32) + dt_bias)[:, heads]
    a = torch.exp(dt * -torch.exp(A_log[heads]))               # (B, H_l)
    xh = xs.reshape(-1, H, P)[:, heads].to(f32)
    dBx = ((dt[:, :, None] * xh)[..., None]
           * Bm.to(f32)[:, None, None, :])                     # (B,H_l,P,S)
    new = ssm * a[:, :, None, None] + dBx
    y = (new @ Cm.to(f32)[:, None, :, None])[..., 0]            # (B,H_l,P)
    ssm.copy_(new)
    return y + D[heads][None, :, None] * xh


@torch.no_grad()
def mamba_step(p: Mamba, cfg, x, cache: MambaCache, *,
               pol=common.NO_SHARDING):
    """One-token Mamba2 step.  x: (B, 1, D) -> (B, 1, D) and the cache,
    whose tensors are updated in place.  A DTensor cache (the decode
    layout of ``sharding.cache_shardings``) takes :func:`_step_sharded`."""
    if isinstance(cache.ssm, DTensor):
        return _step_sharded(p, cfg, x, cache, pol)
    B = x.shape[0]
    d_inner = dims(cfg)[0]
    z, xbc, dt = _split_proj(cfg, x[:, 0] @ common.cast(p.in_proj, cfg))
    y = _step_core(cfg, xbc, dt, common.cast(p.conv_w, cfg),
                   common.cast(p.conv_b, cfg), p.dt_bias, p.A_log, p.D,
                   cache.conv, cache.ssm)
    y = y.reshape(B, d_inner).to(x.dtype)
    y = common.rms_norm(y * F.silu(z), p.gate_norm, cfg.norm_eps)
    return (y @ common.cast(p.out_proj, cfg))[:, None, :], cache


def _split_dim(x, dim):
    """The one mesh dim of DTensor ``x`` that splits tensor dim ``dim``
    (None if none does)."""
    dims_ = [i for i, pl in enumerate(x.placements) if pl.is_shard(dim)]
    if len(dims_) > 1:
        raise ValueError(f"dim {dim} split over several mesh dims: "
                         f"{x.placements}")
    return dims_[0] if dims_ else None


def _step_sharded(p: Mamba, cfg, x, cache: MambaCache, pol):
    """:func:`mamba_step` on a sharded cache: conv tail (B, W - 1, C) with
    its channels split on one mesh dim, state (B, H, P, S) with its heads
    split on one (``model`` in the decode layout), both with B split as
    the cache says.

    The in-projection's output is made whole on every rank of a batch
    shard (its parts are not multiples of a shard), and the rest runs in
    ``local_map``: each rank convolves its channels of the tail with its
    columns of ``conv_w`` / ``conv_b`` and writes its tail shard, the
    convolved channels are gathered (the split into x, B and C crosses
    the shards), and the rank advances the state of its heads in place.
    The output y (B, H, P) comes back split on H as the state is; the
    gate, its norm and ``out_proj`` run on DTensors."""
    B = x.shape[0]
    d_inner = dims(cfg)[0]
    c = lambda w: common.cast(w, cfg, pol)
    zxbcdt = _batch_only(common._dense(x[:, 0], c(p.in_proj)))
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    mesh = cache.ssm.device_mesh
    bat = tuple(Shard(0) if pl.is_shard(0) else Replicate()
                for pl in cache.ssm.placements)
    if tuple(pl for pl in cache.conv.placements if pl.is_shard(0)) != tuple(
            pl for pl in bat if pl.is_shard(0)):
        raise ValueError("the Mamba conv tail and state split the batch "
                         "differently")
    cdim, hdim = _split_dim(cache.conv, 2), _split_dim(cache.ssm, 1)
    if _split_dim(cache.conv, 1) is not None or any(
            pl.is_shard() and pl.dim > 1 for pl in cache.ssm.placements):
        raise ValueError("a Mamba cache splits its batch, channels and "
                         "heads only")
    rep = (Replicate(),) * mesh.ndim
    on = lambda d, tdim: tuple(Shard(tdim) if i == d else Replicate()
                               for i in range(mesh.ndim))
    cw_pl, cb_pl = on(cdim, 1), on(cdim, 0)
    y_pl = tuple(Shard(1) if i == hdim else pl for i, pl in enumerate(bat))
    rc = mesh.get_local_rank(cdim) if cdim is not None else 0
    rh = mesh.get_local_rank(hdim) if hdim is not None else 0
    gather = (functools.partial(common.all_gather, mesh=mesh, mesh_dim=cdim,
                                dim=1)
              if cdim is not None and mesh.size(cdim) > 1 else None)

    def local(xbc_l, dt_l, cw, cb, dt_bias, A_log, Dp, conv, ssm_state):
        Hl = ssm_state.shape[1]
        return _step_core(cfg, xbc_l, dt_l, cw, cb, dt_bias, A_log, Dp,
                          conv, ssm_state, ch_off=rc * conv.shape[2],
                          heads=slice(rh * Hl, (rh + 1) * Hl),
                          gather=gather)

    fn = local_map(
        local, out_placements=list(y_pl),
        in_placements=(bat, bat, cw_pl, cb_pl, rep, rep, rep,
                       tuple(cache.conv.placements),
                       tuple(cache.ssm.placements)),
        device_mesh=mesh, redistribute_inputs=True)
    y = fn(xbc, dt, c(p.conv_w), c(p.conv_b), pol.weight(p.dt_bias),
           pol.weight(p.A_log), pol.weight(p.D), cache.conv, cache.ssm)
    y = y.reshape(B, d_inner).to(x.dtype)
    y = common.rms_norm(y * F.silu(z), pol.weight(p.gate_norm),
                        cfg.norm_eps)
    out = common._dense(y, c(p.out_proj))[:, None, :]
    return pol.resid(out), cache
