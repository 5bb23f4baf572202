"""CUDA kernels: one fused LSTM step and its backward.

:func:`lstm_cell` replaces the TPU kernel
``repro/kernels/lstm_cell.py::lstm_cell_padded`` (body ``_lstm_kernel``).
The kernel (``csrc/lstm_cell.cu``) computes both matrix products and the
gate nonlinearities in its own body, spread over the card; its source note
says what bounds it and how its design answers that.  Unlike the TPU
kernel it needs no padding of I or B.

:func:`lstm_cell_bwd` is the step's backward, a kernel of the same source
that the TPU package has no counterpart of (JAX cannot differentiate
through its own LSTM kernel).  It reads the gates that the forward saved,
in one pass where the shape allows it (:func:`single_pass`, which holds
the search's step), else through a kernel that tiles dG over hidden
units.  :class:`LSTMCellFn` joins the forward and the backward into an
autograd Function.

Both take I + H up to :data:`MAX_K`, the limit of the port's first LSTM
kernel, and raise a ``ValueError`` past it.  Each launch is counted in
``build.launches`` (``lstm_cell``, ``lstm_cell_bwd``).
"""
from __future__ import annotations

import ctypes
from array import array

import torch

from repro_torch.kernels import build

# The largest I + H the kernels take (``kMaxK`` in the source): the
# forward's staged rows of x and h then fill 194 KB of shared memory.
MAX_K = 12288
# The single-pass backward's limits (``kUntiledMaxB`` and
# ``kUntiledMaxCols`` x ``kThreads`` gate columns in the source).
SINGLE_PASS_MAX_B = 32
SINGLE_PASS_MAX_COLS = 10 * 256
_fn = None
_bwd_fn = None
_NAMES = ("x", "h", "c", "wx", "wh", "b")
_BWD_NAMES = ("x", "h", "c", "wx", "wh", "gates", "dh_new", "dc_new")


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("lstm_cell").lstm_cell_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_launcher():
    global _bwd_fn
    if _bwd_fn is None:
        fn = build.load("lstm_cell").lstm_cell_bwd_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def _dims(x, h):
    xs, hs = x.shape, h.shape
    if len(xs) != 2 or len(hs) != 2:
        raise ValueError("lstm_cell: x and h must be 2-D (B, I), (B, H)")
    if xs[1] + hs[1] > MAX_K:
        raise ValueError(f"lstm_cell: I + H = {xs[1] + hs[1]} exceeds the "
                         f"kernels' limit of {MAX_K}")
    return xs[0], xs[1], hs[1]


def lstm_cell(x, h, c, wx, wh, b):
    """Launch the forward kernel.  x (B, I), h/c (B, H), wx (I, 4H),
    wh (H, 4H), b (4H,): contiguous float32 CUDA tensors on one card,
    I + H <= :data:`MAX_K`.

    Returns one (7, B, H) buffer: h', then c', then the gates the
    backward reads, sig(i), sig(f), tanh(g), sig(o), tanh(c').
    """
    B, I, H = _dims(x, h)
    ptrs, index = build.check_inputs(
        (x, h, c, wx, wh, b), _NAMES,
        ((B, I), (B, H), (B, H), (I, 4 * H), (H, 4 * H), (4 * H,)))
    out = x.new_empty((7, B, H))
    if B:
        # The library reads its pointers and sizes from one array.
        args = array("q", ptrs)
        args.extend((out.data_ptr(), B, I, H))
        stream = build.stream(index)
        rc = _launcher()(args.buffer_info()[0], index, stream)
        if rc != 0:
            raise RuntimeError(
                f"lstm_cell kernel launch failed: CUDA error {rc}")
        build.count("lstm_cell", stream)
    return out


def single_pass(B, H):
    """Whether the backward of a (B, ., H) step runs in one pass."""
    return B <= SINGLE_PASS_MAX_B and 4 * H <= SINGLE_PASS_MAX_COLS


def lstm_cell_bwd(x, h, c, wx, wh, gates, dh_new, dc_new, tiled=False):
    """Launch the backward kernel.  x, h, c, wx, wh as in
    :func:`lstm_cell`; ``gates`` (5, B, H) as it saved them; dh_new and
    dc_new (B, H), the gradients of h' and c'.  All contiguous float32
    CUDA tensors on one card, I + H <= :data:`MAX_K`.  The single-pass
    kernel runs where :func:`single_pass` allows it and ``tiled`` is
    false; else the tiled one (dG through shared memory in tiles of
    hidden units where a whole row does not fit).

    Returns (dx, dh, dc, dwx, dwh, db); two calls on the same inputs give
    the same bits (no atomics).  With B = 0 the weight gradients are 0.
    """
    B, I, H = _dims(x, h)
    ptrs, index = build.check_inputs(
        (x, h, c, wx, wh, gates, dh_new, dc_new), _BWD_NAMES,
        ((B, I), (B, H), (B, H), (I, 4 * H), (H, 4 * H), (5, B, H), (B, H),
         (B, H)))
    # Three buffers: dx; dh and dc; the weight gradients as one
    # (I + H + 1, 4H) table whose last row is db.
    dx = x.new_empty((B, I))
    dhc = x.new_empty((2, B, H))
    dw = x.new_empty((I + H + 1, 4 * H)) if B else x.new_zeros(
        (I + H + 1, 4 * H))
    if B:
        args = array("q", ptrs)
        args.extend((dx.data_ptr(), dhc.data_ptr(), dw.data_ptr(), B, I, H,
                     int(tiled or not single_pass(B, H))))
        stream = build.stream(index)
        rc = _bwd_launcher()(args.buffer_info()[0], index, stream)
        if rc != 0:
            raise RuntimeError(
                f"lstm_cell backward kernel launch failed: CUDA error {rc}")
        build.count("lstm_cell_bwd", stream)
    dh, dc = dhc.unbind(0)
    dwx, dwh, db = dw.split((I, H, 1))
    return dx, dh, dc, dwx, dwh, db.view(4 * H)


class LSTMCellFn(torch.autograd.Function):
    """The CUDA LSTM step with its gradient: the forward kernel saves the
    gates, the backward kernel reads them."""

    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b):
        out = lstm_cell(x, h, c, wx, wh, b)
        ctx.save_for_backward(x, h, c, wx, wh, out)
        return out[0], out[1]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dh_new, dc_new):
        x, h, c, wx, wh, out = ctx.saved_tensors
        # Autograd materializes an unused output's gradient as zeros; an
        # upstream gradient may come as a broadcast (stride-0) view.
        return lstm_cell_bwd(x, h, c, wx, wh, out[2:], dh_new.contiguous(),
                             dc_new.contiguous())
