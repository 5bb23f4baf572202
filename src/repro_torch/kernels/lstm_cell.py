"""CUDA kernel: one fused LSTM step (the REINFORCE policy step).

Replaces the TPU kernel ``repro/kernels/lstm_cell.py::lstm_cell_padded``
(body ``_lstm_kernel``).  The kernel (``csrc/lstm_cell.cu``) computes both
matrix products and the gate nonlinearities in its own body; its source
note says what bounds it on the card and how its design answers that.
Unlike the TPU kernel it needs no padding of I or B.

:class:`LSTMCellFn` gives the kernel a gradient: forward launches it,
backward recomputes the gates and applies the LSTM formula in plain
PyTorch (:func:`repro_torch.kernels.ref.lstm_cell_bwd_ref`).

``launches`` counts the forward kernel launches made through
:func:`lstm_cell`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

launches = 0
_fn = None
_MAX_SMEM = 48 * 1024   # static launch limit for dynamic shared memory


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("lstm_cell").lstm_cell_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def lstm_cell(x, h, c, wx, wh, b):
    """Launch the kernel.  x (B, I), h/c (B, H), wx (I, 4H), wh (H, 4H),
    b (4H,): contiguous float32 CUDA tensors on one device.
    Returns (h', c'), each (B, H)."""
    global launches
    if x.dim() != 2 or h.dim() != 2:
        raise ValueError("lstm_cell: x and h must be 2-D (B, I), (B, H)")
    B, I = x.shape
    H = h.shape[1]
    if (I + H) * 4 > _MAX_SMEM:
        raise ValueError(f"lstm_cell: I + H = {I + H} exceeds the kernel's "
                         "shared-memory limit")
    dev = x.device
    ptrs = [build.check_input(t, n, s, dev) for t, n, s in (
        (x, "x", (B, I)), (h, "h", (B, H)), (c, "c", (B, H)),
        (wx, "wx", (I, 4 * H)), (wh, "wh", (H, 4 * H)), (b, "b", (4 * H,)))]
    out = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    h_out, c_out = out.unbind(0)
    if B == 0:
        return h_out, c_out
    rc = _launcher()(*ptrs, h_out.data_ptr(), c_out.data_ptr(), B, I, H,
                     dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lstm_cell kernel launch failed: CUDA error {rc}")
    launches += 1
    return h_out, c_out


class LSTMCellFn(torch.autograd.Function):
    """The CUDA LSTM step with its gradient."""

    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b):
        ctx.save_for_backward(x, h, c, wx, wh, b)
        return lstm_cell(x, h, c, wx, wh, b)

    @staticmethod
    def backward(ctx, dh_new, dc_new):
        # Autograd materializes an unused output's gradient as zeros.
        x, h, c, wx, wh, b = ctx.saved_tensors
        return ref.lstm_cell_bwd_ref(x, h, c, wx, wh, b, dh_new, dc_new)
