"""Public, shape-flexible entry points for the port's kernels.

A CPU tensor goes to the plain version in :mod:`repro_torch.kernels.ref`;
a CUDA tensor launches the CUDA kernel, or the launch raises.  There is no
fallback between the two.  The device is that of the tensors the caller
passes (numbers and numpy arrays go to it); tensors on two devices raise.
"""
from __future__ import annotations

import torch

from repro_torch.costmodel.layers import NUM_FIELDS
from repro_torch.kernels import (build, costmodel_eval, flash_decode,
                                 lstm_cell, ref)


def _device(*vals) -> torch.device:
    """The one device of the tensors among ``vals`` (the CPU if none is)."""
    devs = {v.device for v in vals if torch.is_tensor(v)}
    if len(devs) > 1:
        raise ValueError("inputs lie on more than one device: "
                         f"{sorted(str(d) for d in devs)}")
    return devs.pop() if devs else torch.device("cpu")


def batched_cost(layers, pe, kt, df):
    """Evaluate a (B, N) batch of per-layer assignments.

    layers: (N, NUM_FIELDS); pe: (B, N); kt/df: broadcastable to (B, N)
    (df may be a scalar).  Returns one (4, B, N) float32 tensor on the
    inputs' device: latency, energy, area, power.
    """
    dev = _device(layers, pe, kt, df)
    layers_t = torch.as_tensor(layers, dtype=torch.float32,
                               device=dev).T.contiguous()
    return table_cost(layers_t, pe, kt, df)


def table_cost(layers_t, pe, kt, df):
    """:func:`batched_cost` against a ready (NUM_FIELDS, N) layer table.

    The searches keep that table on the environment
    (``EnvArrays.layers_t``), or pass one layer's row as an
    (NUM_FIELDS, 1) view, so no call copies it.  pe, kt and df each
    broadcast to (B, N): (B, N), (B, 1), (1, N), (N,), one value or a
    Python number; B is the first size of a 2-D one (1 if none is).  On
    the card the kernel reads them where they lie (no copy, and a number
    goes by value); every form gives the same bits.  Returns one
    (4, B, N) float32 tensor: latency, energy, area, power.
    """
    if layers_t.is_cuda:
        # The kernel's wrapper checks that every tensor lies on this card.
        return costmodel_eval.cost_eval(
            layers_t, *(_as_operand(v, layers_t.device) for v in (pe, kt, df)))
    dev = _device(layers_t, pe, kt, df)
    as_f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    layers_t = as_f32(layers_t)
    vals = [as_f32(v) for v in (pe, kt, df)]
    B = max((v.shape[0] for v in vals if v.dim() == 2), default=1)
    N = layers_t.shape[1]
    return torch.stack(ref.cost_eval_ref(
        layers_t, *(v.expand(B, N) for v in vals)))


def _as_operand(v, dev):
    """``v`` as the cost kernel takes it: a float32 tensor (converted only
    if it is of another type) or a Python number."""
    if isinstance(v, torch.Tensor):
        return v if v.dtype is torch.float32 else v.to(torch.float32)
    if isinstance(v, (int, float)):
        return v
    return torch.as_tensor(v, dtype=torch.float32, device=dev)


def batched_cost_multi(layers, pe, kt, df, interleaved=False):
    """Evaluate a batch where every point has its own layer descriptors.

    layers: (B, N, NUM_FIELDS), or (M, NUM_FIELDS) for a flat list of M
    points; pe/kt/df broadcast to its leading shape ((B, N) or (M,)) and
    may be Python numbers.  Returns (latency, energy, area, power), each of
    that shape, float32 on the inputs' device; with ``interleaved`` one
    (..., 4) tensor instead, each point's four costs side by side.  This
    is the search service's shape: one call evaluates points of different
    workloads side by side (its batcher passes the columns of its packed
    (M, ROW_WIDTH) rows, and stores each point's costs as one row).  Each
    input goes to the per-row kernel (its plain version on the CPU) as a
    flat view where one exists, read through its stride; a broadcast that
    no stride can express is copied.  Every form gives the same bits.
    Rows with ``repeat = 0`` come out exactly 0, so a caller may pad
    ragged workloads with them.
    """
    dev = _device(layers, pe, kt, df)
    layers = torch.as_tensor(layers, dtype=torch.float32, device=dev)
    if layers.dim() not in (2, 3) or layers.shape[-1] != NUM_FIELDS:
        raise ValueError(f"layers: expected (B, N, {NUM_FIELDS}) or (M, "
                         f"{NUM_FIELDS}), got {tuple(layers.shape)}")
    vals = [torch.as_tensor(v, dtype=torch.float32, device=dev)
            for v in (pe, kt, df)]
    lead = torch.broadcast_shapes(layers.shape[:-1], *(v.shape for v in vals))
    flat = layers.expand(*lead, NUM_FIELDS).reshape(-1, NUM_FIELDS)
    if flat.stride(1) != 1:
        flat = flat.contiguous()
    vals = [v.expand(lead).reshape(-1) for v in vals]
    if dev.type == "cpu":
        out = torch.stack(ref.cost_eval_multi_ref(flat, *vals), dim=-1)
    else:
        out = costmodel_eval.cost_eval_multi(flat, *vals)
    out = out.reshape(*lead, 4)
    return out if interleaved else tuple(out.unbind(-1))


def lstm_step(x, h, c, wx, wh, b):
    """One LSTM cell step.  x: (B, I); h/c: (B, H); wx: (I, 4H); wh:
    (H, 4H); b: (4H,).  Returns (h', c').

    Differentiable on both paths: autograd through the plain version on
    the CPU, :class:`~repro_torch.kernels.lstm_cell.LSTMCellFn` (the
    forward and the backward kernel) on CUDA, where every input must be
    contiguous.
    """
    if _device(x, h, c, wx, wh, b).type == "cpu":
        return ref.lstm_cell_ref(x, h, c, wx, wh, b)
    return lstm_cell.LSTMCellFn.apply(x, h, c, wx, wh, b)


def decode_attention(q, k, v):
    """Single-token GQA attention over a KV cache.

    q: (B, Hq, D); k/v: (B, T, Hkv, D), any T >= 1; a view
    ``cache[:, :T]`` of a longer cache is read in place.  Returns
    (B, Hq, D) float32.  On CUDA tensors the flash-decode kernel runs for
    every T (it raises on a shape or type it does not take); the
    reference's oracle path for T % 512 != 0 has no counterpart here.
    """
    if _device(q, k, v).type == "cpu":
        return ref.flash_decode_ref(q, k, v)
    return flash_decode.flash_decode(q.contiguous(), k, v)


def decode_attention_partials(q, k, v, shards=1, shard_rows=None):
    """The partials of :func:`decode_attention` over one rank's slice of
    a KV cache sharded on its sequence over ``shards`` ranks of
    ``shard_rows`` rows each (``k.shape[1]`` by default): q (B, Hq, D);
    k/v (B, T, Hkv, D), the slice's valid rows, any T >= 0.  Returns
    (B, Hq, W, D + 2) float32 partials (acc, m, l) in sequence order,
    with W the same on every rank.  On CUDA tensors the split kernel's
    (at most ``flash_decode.shard_width(shards, shard_rows)`` splits, no
    launch for T = 0) padded with neutral partials to that width; on the
    CPU the plain version's one partial (the neutral one for T = 0)."""
    if _device(q, k, v).type == "cpu":
        return ref.flash_decode_partials_ref(q, k, v)
    width = flash_decode.shard_width(
        shards, k.shape[1] if shard_rows is None else shard_rows)
    parts = flash_decode.flash_decode_partials(q.contiguous(), k, v, width)
    B, Hq, S, D2 = parts.shape
    if S < width:
        parts = torch.cat([parts, ref.neutral_partials(
            B, Hq, width - S, D2 - 2, parts.device)], dim=2)
    return parts


def decode_attention_combine(parts):
    """Partials (B, Hq, S, D + 2) float32, in sequence order -> the
    attention (B, Hq, D) float32: the combine kernel on CUDA tensors, its
    plain version on the CPU."""
    if parts.device.type == "cpu":
        return ref.flash_decode_combine_ref(parts)
    return flash_decode.flash_decode_combine(parts.contiguous())


def launch_counts():
    """Kernel launches so far, by kernel (``lstm_cell_bwd`` counts the
    LSTM step's backward kernel, ``flash_decode`` the attention calls,
    ``flash_decode_combine`` the combine kernel's launches, among them
    and by :func:`decode_attention_combine`, ``flash_decode_partials``
    the split kernel's by :func:`decode_attention_partials`).
    A CUDA graph's replays count the launches its capture recorded; the
    capture and its warm-up count none."""
    return dict(build.launches)


def reset_launch_counts():
    """Set every kernel's launch count, and the plain versions' count of
    calls on CUDA tensors, to 0."""
    build.reset_launches()
    for k in ref.cuda_calls:
        ref.cuda_calls[k] = 0
