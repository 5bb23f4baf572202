"""Plain PyTorch versions of the port's kernels.

Each function is the ground truth its kernel is held against (on the card
by ``chip_smoke.py``, and against the JAX package on the CPU by
``tests/test_torch_*.py``).  The wrappers in :mod:`repro_torch.kernels.ops`
use them only for tensors that lie on the CPU; ``cuda_calls`` counts the
calls made with CUDA tensors, so a run can show that none of them was on
its main path.
"""
from __future__ import annotations

import math

import torch

from repro_torch.costmodel import maestro
from repro_torch.costmodel.layers import NUM_FIELDS

# Calls made with CUDA tensors, by function name.
cuda_calls = {"cost_eval_ref": 0, "cost_eval_multi_ref": 0,
              "lstm_cell_ref": 0, "lstm_cell_saved_ref": 0,
              "lstm_cell_bwd_ref": 0, "lstm_cell_bwd_saved_ref": 0,
              "flash_decode_ref": 0, "flash_decode_partials_ref": 0,
              "flash_decode_combine_ref": 0}


def _count(name, t):
    if t.is_cuda:
        cuda_calls[name] += 1


def cost_eval_ref(layers_t, pe, kt, df):
    """Plain version of the cost kernel: (NUM_FIELDS, N) x (B, N) -> 4x(B, N).

    Runs :func:`repro_torch.costmodel.maestro.core_cost`, the hard model
    core, with plain broadcasting.
    """
    _count("cost_eval_ref", pe)
    fields = [layers_t[i][None, :] for i in range(NUM_FIELDS)]
    out = maestro.core_cost(*fields, pe, kt, df)
    return out.latency, out.energy, out.area, out.power


def cost_eval_multi_ref(layers, pe, kt, df):
    """Plain version of the per-row kernel: (M, NUM_FIELDS) x (M,) -> 4x(M,).

    Every point carries its own layer row (the search service's fused
    dispatch); the same :func:`~repro_torch.costmodel.maestro.core_cost`
    as :func:`cost_eval_ref`, on the fields' columns.
    """
    _count("cost_eval_multi_ref", pe)
    fields = [layers[:, i] for i in range(NUM_FIELDS)]
    out = maestro.core_cost(*fields, pe, kt, df)
    return out.latency, out.energy, out.area, out.power


def _sig(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _gates(x, h, wx, wh, b):
    gates = x @ wx + h @ wh + b
    H = h.shape[-1]
    i = _sig(gates[..., 0 * H:1 * H])
    f = _sig(gates[..., 1 * H:2 * H])
    g = torch.tanh(gates[..., 2 * H:3 * H])
    o = _sig(gates[..., 3 * H:4 * H])
    return i, f, g, o


def lstm_cell_ref(x, h, c, wx, wh, b):
    """Plain version of the LSTM kernel: one LSTM step.

    x: (B, I), h/c: (B, H), wx: (I, 4H), wh: (H, 4H), b: (4H,).
    Gate order: i, f, g, o.  Returns (h', c').
    """
    _count("lstm_cell_ref", x)
    i, f, g, o = _gates(x, h, wx, wh, b)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def lstm_cell_saved_ref(x, h, c, wx, wh, b):
    """Plain version of the LSTM kernel run for autograd: (h', c') and the
    gates it saves for the backward, (5, B, H) = sig(i), sig(f), tanh(g),
    sig(o), tanh(c')."""
    _count("lstm_cell_saved_ref", x)
    i, f, g, o = _gates(x, h, wx, wh, b)
    c_new = f * c + i * g
    tc = torch.tanh(c_new)
    return o * tc, c_new, torch.stack([i, f, g, o, tc])


def lstm_cell_bwd_ref(x, h, c, wx, wh, b, dh_new, dc_new):
    """Gradient of :func:`lstm_cell_ref` by the LSTM formula.

    Recomputes the gates from the saved inputs and returns
    ``(dx, dh, dc, dwx, dwh, db)`` for upstream gradients ``dh_new`` and
    ``dc_new`` of (h', c').  The ground truth of the backward kernel, by
    way of :func:`lstm_cell_bwd_saved_ref`.
    """
    _count("lstm_cell_bwd_ref", x)
    i, f, g, o = _gates(x, h, wx, wh, b)
    tc = torch.tanh(f * c + i * g)
    return _lstm_bwd(x, h, c, wx, wh, (i, f, g, o, tc), dh_new, dc_new)


def lstm_cell_bwd_saved_ref(x, h, c, wx, wh, gates, dh_new, dc_new):
    """Plain version of the backward kernel, in its signature: the gradient
    of :func:`lstm_cell_ref` from the gates that :func:`lstm_cell_saved_ref`
    (or the forward kernel) saved, (5, B, H).  Returns
    ``(dx, dh, dc, dwx, dwh, db)``."""
    _count("lstm_cell_bwd_saved_ref", x)
    return _lstm_bwd(x, h, c, wx, wh, gates.unbind(0), dh_new, dc_new)


def _lstm_bwd(x, h, c, wx, wh, gates, dh_new, dc_new):
    i, f, g, o, tc = gates
    dc_tot = dc_new + dh_new * o * (1.0 - tc * tc)
    d_i = dc_tot * g * i * (1.0 - i)
    d_f = dc_tot * c * f * (1.0 - f)
    d_g = dc_tot * i * (1.0 - g * g)
    d_o = dh_new * tc * o * (1.0 - o)
    dG = torch.cat([d_i, d_f, d_g, d_o], dim=-1)          # (B, 4H)
    return (dG @ wx.T, dG @ wh.T, dc_tot * f,
            x.T @ dG, h.T @ dG, dG.sum(dim=0))


def flash_decode_ref(q, k, v):
    """Plain version of the flash-decode kernel: single-token GQA attention.

    q: (B, Hq, D), k/v: (B, T, Hkv, D) with Hq % Hkv == 0; any float type,
    computed in float32 (as the reference wrapper casts).  Query head
    h*G + g attends KV head h, G = Hq / Hkv.  Returns (B, Hq, D) float32.
    """
    _count("flash_decode_ref", q)
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bhgd,bthd->bhgt", qg, k) / math.sqrt(D)
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    return torch.einsum("bhgt,bthd->bhgd", w, v).reshape(B, Hq, D)


def neutral_partials(B, Hq, S, D, device):
    """S neutral partials a query row, (B, Hq, S, D + 2) float32: acc = 0,
    m = -inf, l = 0, the partial of a cache slice with no valid key.  The
    combine weighs it by exp(-inf - M) = 0."""
    out = torch.zeros((B, Hq, S, D + 2), dtype=torch.float32, device=device)
    out[..., D] = -math.inf
    return out


def flash_decode_partials_ref(q, k, v, keys_per_split=None):
    """Plain version of the split kernel's partials: split s takes keys
    ``[s * keys_per_split, (s + 1) * keys_per_split)`` cut at T (one split
    of all T keys by default) and gives, per query row, its unnormalised
    ``acc`` (D values), its max logit ``m`` and its sum of
    ``exp(logit - m)``, ``l``.  Returns (B, Hq, S, D + 2) float32, the
    layout of the kernel's workspace.  T = 0 (a slice of a sharded cache
    with no valid key) gives one neutral partial (:func:`neutral_partials`).
    """
    _count("flash_decode_partials_ref", q)
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if T == 0:
        return neutral_partials(B, Hq, 1, D, q.device)
    keys_per_split = keys_per_split or T
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    qg = q.reshape(B, Hkv, Hq // Hkv, D)
    parts = []
    for t0 in range(0, T, keys_per_split):
        ks, vs = k[:, t0:t0 + keys_per_split], v[:, t0:t0 + keys_per_split]
        logits = torch.einsum("bhgd,bthd->bhgt", qg, ks) / math.sqrt(D)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        acc = torch.einsum("bhgt,bthd->bhgd", p, vs)
        parts.append(torch.cat([acc, m, p.sum(dim=-1, keepdim=True)], -1)
                     .reshape(B, Hq, 1, D + 2))
    return torch.cat(parts, dim=2)


def flash_decode_combine_ref(parts):
    """Plain version of the combine kernel: (B, Hq, S, D + 2) partials ->
    (B, Hq, D), each split rescaled by ``exp(m_s - M)`` and summed in the
    order s = 0, 1, ..., then divided by the total ``l``.  Neutral
    partials (m = -inf) get the weight 0 and add exact zeros, as long as
    each row has one partial that is not neutral (M finite)."""
    _count("flash_decode_combine_ref", parts)
    D = parts.shape[-1] - 2
    m = parts[..., D]
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))      # (B, Hq, S)
    acc = torch.zeros_like(parts[:, :, 0, :D])
    total = torch.zeros_like(m[:, :, 0])
    for s in range(parts.shape[2]):
        acc = acc + w[:, :, s, None] * parts[:, :, s, :D]
        total = total + w[:, :, s] * parts[:, :, s, D + 1]
    return acc / total[..., None]


def flash_decode_split_ref(q, k, v, keys_per_split):
    """Split-and-combine in plain PyTorch: the kernel's algorithm, equal to
    :func:`flash_decode_ref` up to the order of the sums."""
    return flash_decode_combine_ref(
        flash_decode_partials_ref(q, k, v, keys_per_split))
