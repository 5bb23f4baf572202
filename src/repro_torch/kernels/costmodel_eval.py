"""CUDA kernels: batched cost evaluation, against one layer table or with a
layer descriptor per point.

:func:`cost_eval` replaces the TPU kernel
``repro/kernels/costmodel_eval.py::cost_eval_padded`` (body
``_cost_kernel``): the hard cost model for every point of a (B, N) batch
against a (NUM_FIELDS, N) layer table.  :func:`cost_eval_multi` replaces
``cost_eval_multi_padded`` (body ``_cost_kernel_multi``): a flat list of M
points, each with its own (NUM_FIELDS,) layer row -- the search service's
fused dispatch.  Both kernels live in ``csrc/costmodel_eval.cu`` and share
its ``core_cost``; the source note says what bounds them on the card and
how their design answers that.  Unlike the TPU kernels they take any
shape: no tiles, no padding.

``launches`` and ``multi_launches`` count the launches made through
:func:`cost_eval` and :func:`cost_eval_multi`.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.costmodel.layers import NUM_FIELDS
from repro_torch.kernels import build

launches = 0
multi_launches = 0
# Worker and dispatcher threads of the search service launch concurrently.
_count_lock = threading.Lock()
_fn = None
_multi_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("costmodel_eval").cost_eval_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _multi_launcher():
    global _multi_fn
    if _multi_fn is None:
        fn = build.load("costmodel_eval").cost_eval_multi_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _multi_fn = fn
    return _multi_fn


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
    with _count_lock:
        launches += 1
    return out.unbind(0)


def cost_eval_multi(layers, pe, kt, df):
    """Launch the per-row kernel.  layers: (M, NUM_FIELDS); pe/kt/df: (M,).

    Every input is a contiguous float32 CUDA tensor on one device.  Returns
    (latency, energy, area, power), each (M,) float32.
    """
    global multi_launches
    if pe.dim() != 1:
        raise ValueError(f"pe: expected (M,), got {tuple(pe.shape)}")
    M = pe.shape[0]
    dev = pe.device
    ptrs = [build.check_input(layers, "layers", (M, NUM_FIELDS), dev)]
    ptrs += [build.check_input(t, n, (M,), dev)
             for t, n in ((pe, "pe"), (kt, "kt"), (df, "df"))]
    out = torch.empty((4, M), dtype=torch.float32, device=dev)
    if M == 0:
        return out.unbind(0)
    rc = _multi_launcher()(*ptrs, *(out[i].data_ptr() for i in range(4)), M,
                           dev.index,
                           torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"cost_eval_multi kernel launch failed: CUDA error {rc}")
    with _count_lock:
        multi_launches += 1
    return out.unbind(0)
