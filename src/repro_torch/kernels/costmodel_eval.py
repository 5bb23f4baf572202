"""CUDA kernels: batched cost evaluation, against one layer table or with a
layer descriptor per point.

:func:`cost_eval` replaces the TPU kernel
``repro/kernels/costmodel_eval.py::cost_eval_padded`` (body
``_cost_kernel``): the hard cost model for every point of a (B, N) batch
against a (NUM_FIELDS, N) layer table.  :func:`cost_eval_multi` replaces
``cost_eval_multi_padded`` (body ``_cost_kernel_multi``): a flat list of M
points, each with its own (NUM_FIELDS,) layer row -- the search service's
fused dispatch -- read through their point strides and written as (M, 4)
rows.  Both kernels live in ``csrc/costmodel_eval.cu`` and share
its ``core_cost``; the source note says what bounds them on the card and
how their design answers that.  Unlike the TPU kernels they take any
shape: no tiles, no padding.

Each launch is counted in ``build.launches`` (``cost_eval``,
``cost_eval_multi``).
"""
from __future__ import annotations

import ctypes
from array import array

import torch

from repro_torch.costmodel.layers import NUM_FIELDS
from repro_torch.kernels import build

# Threads per block of the per-row kernel.  Most of the service's launches
# carry few points (phase 7 on an H100: 169 of 182 at most 64, median 3),
# so one block holds them whatever its size; over that mix 64, 128 and 256
# threads give device times within 1% of each other
# (tools/tune_cost_multi.py), and 128 is the table kernel's.
MULTI_THREADS = 128

_fn = None
_multi_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("costmodel_eval").cost_eval_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _multi_launcher():
    global _multi_fn
    if _multi_fn is None:
        fn = build.load("costmodel_eval").cost_eval_multi_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _multi_fn = fn
    return _multi_fn


def broadcast_strides(shape, stride, B, N, name):
    """The row and column strides, in elements, that read a tensor of
    ``shape`` and ``stride`` (0, 1 or 2 dimensions) as a (B, N) batch: a
    dimension of size 1, or a missing one, gets stride 0 (broadcast).
    Raises unless the shape broadcasts to (B, N) and no stride is
    negative."""
    d = len(shape)
    if d == 2:
        (r, n), (rs, cs) = shape, stride
    elif d == 1:
        r, rs, n, cs = 1, 0, shape[0], stride[0]
    elif d == 0:
        return 0, 0
    else:
        raise ValueError(f"{name}: {d} dimensions; expected at most 2")
    if rs < 0 or cs < 0:
        raise ValueError(f"{name}: negative stride {tuple(stride)}")
    if r not in (1, B) or n not in (1, N):
        raise ValueError(f"{name}: shape {tuple(shape)} does not broadcast "
                         f"to ({B}, {N})")
    return (rs if r != 1 else 0), (cs if n != 1 else 0)


def cost_eval(layers_t, pe, kt, df):
    """Launch the table kernel.

    layers_t: a contiguous (NUM_FIELDS, N) float32 CUDA tensor.  pe, kt,
    df: each a float32 tensor on the same card that broadcasts to (B, N)
    -- (B, N), (B, 1), (1, N), (N,) or one value, any strides, read in
    place -- or a Python number, passed by value.  B is the first size of
    a 2-D operand (1 if none is).  Returns one (4, B, N) float32 tensor:
    latency, energy, area and power, in that order.
    """
    index = layers_t.get_device()
    if index < 0:
        raise ValueError("layers_t: expected a CUDA tensor")
    shape = layers_t.shape
    if layers_t.dtype is not torch.float32:
        raise ValueError(f"layers_t: dtype {layers_t.dtype}, expected "
                         "float32")
    if (len(shape) != 2 or shape[0] != NUM_FIELDS
            or not layers_t.is_contiguous()):
        raise ValueError(f"layers_t: shape {tuple(shape)}; expected a "
                         f"contiguous ({NUM_FIELDS}, N)")
    N = shape[1]
    operands = (pe, kt, df)
    shapes = [v.shape if isinstance(v, torch.Tensor) else () for v in operands]
    B = max((s[0] for s in shapes if len(s) == 2), default=1)
    # The launch arguments as the library reads them (one array of
    # pointers, strides and sizes, one of by-value operands).
    args = [layers_t.data_ptr()]
    values = [0.0, 0.0, 0.0]
    for i, (v, shape, name) in enumerate(zip(operands, shapes,
                                             ("pe", "kt", "df"))):
        if not isinstance(v, torch.Tensor):
            args += (0, 0, 0)
            values[i] = v
            continue
        if v.get_device() != index:
            raise ValueError(f"{name}: expected a CUDA tensor on "
                             f"cuda:{index}")
        if v.dtype is not torch.float32:
            raise ValueError(f"{name}: dtype {v.dtype}, expected float32")
        args += (v.data_ptr(),
                 *broadcast_strides(shape, v.stride(), B, N, name))
    out = layers_t.new_empty((4, B, N))
    if B * N == 0:
        return out
    args += (out.data_ptr(), B, N)
    packed, vals = array("q", args), array("f", values)
    stream = build.stream(index)
    rc = _launcher()(packed.buffer_info()[0], vals.buffer_info()[0], index,
                     stream)
    if rc != 0:
        raise RuntimeError(f"cost_eval kernel launch failed: CUDA error {rc}")
    build.count("cost_eval", stream)
    return out


def cost_eval_multi(layers, pe, kt, df):
    """Launch the per-row kernel.

    layers: an (M, NUM_FIELDS) float32 CUDA tensor whose fields lie side
    by side (stride 1), any row stride; pe, kt, df: (M,) (or one value)
    float32 tensors on the same card, any stride.  Each is read in place:
    the search service passes the columns of its packed (M, 11) rows.
    Returns one (M, 4) float32 tensor, each point's latency, energy, area
    and power side by side.
    """
    index = layers.get_device()
    if index < 0:
        raise ValueError("layers: expected a CUDA tensor")
    if layers.dtype is not torch.float32:
        raise ValueError(f"layers: dtype {layers.dtype}, expected float32")
    shape, stride = layers.shape, layers.stride()
    if len(shape) != 2 or shape[1] != NUM_FIELDS or stride[1] != 1:
        raise ValueError(f"layers: shape {tuple(shape)}, strides "
                         f"{tuple(stride)}; expected (M, {NUM_FIELDS}) "
                         "with its fields side by side")
    M = shape[0]
    strides = [broadcast_strides(shape[:1], stride[:1], 1, M, "layers")[1]]
    args = [layers.data_ptr()]
    for v, name in ((pe, "pe"), (kt, "kt"), (df, "df")):
        if v.get_device() != index:
            raise ValueError(f"{name}: expected a CUDA tensor on "
                             f"cuda:{index}")
        if v.dtype is not torch.float32:
            raise ValueError(f"{name}: dtype {v.dtype}, expected float32")
        args.append(v.data_ptr())
        strides.append(broadcast_strides(v.shape, v.stride(), 1, M, name)[1])
    if max((M - 1) * strides[0] + NUM_FIELDS, (M - 1) * max(strides),
           4 * M + MULTI_THREADS) >= 1 << 31:
        raise ValueError(f"cost_eval_multi: {M} points at strides "
                         f"{strides} reach past 2**31 elements")
    out = layers.new_empty((M, 4))
    if M == 0:
        return out
    packed = array("q", (*args, *strides, out.data_ptr(), M, MULTI_THREADS))
    stream = build.stream(index)
    rc = _multi_launcher()(packed.buffer_info()[0], index, stream)
    if rc != 0:
        raise RuntimeError(
            f"cost_eval_multi kernel launch failed: CUDA error {rc}")
    build.count("cost_eval_multi", stream)
    return out
