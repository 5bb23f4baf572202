"""CUDA kernel: batched (design-point x layer) cost evaluation.

Replaces the TPU kernel ``repro/kernels/costmodel_eval.py::cost_eval_padded``
(body ``_cost_kernel``).  The kernel (``csrc/costmodel_eval.cu``) runs the
hard cost model for every point of a (B, N) batch against a
(NUM_FIELDS, N) layer table; its source note says what bounds it on the
card and how its design answers that.  Unlike the TPU kernel it takes any
B and N: no tiles, no padding.

``launches`` counts the kernel launches made through :func:`cost_eval`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.costmodel.layers import NUM_FIELDS
from repro_torch.kernels import build

launches = 0
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("costmodel_eval").cost_eval_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def cost_eval(layers_t, pe, kt, df):
    """Launch the kernel.  layers_t: (NUM_FIELDS, N); pe/kt/df: (B, N).

    Every input is a contiguous float32 CUDA tensor on one device.  Returns
    (latency, energy, area, power), each (B, N) float32.
    """
    global launches
    if pe.dim() != 2:
        raise ValueError(f"pe: expected (B, N), got {tuple(pe.shape)}")
    B, N = pe.shape
    dev = pe.device
    ptrs = [build.check_input(layers_t, "layers_t", (NUM_FIELDS, N), dev)]
    ptrs += [build.check_input(t, n, (B, N), dev)
             for t, n in ((pe, "pe"), (kt, "kt"), (df, "df"))]
    out = torch.empty((4, B, N), dtype=torch.float32, device=dev)
    if B * N == 0:
        return out.unbind(0)
    rc = _launcher()(*ptrs, *(out[i].data_ptr() for i in range(4)), B, N,
                     dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cost_eval kernel launch failed: CUDA error {rc}")
    launches += 1
    return out.unbind(0)
