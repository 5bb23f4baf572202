"""CUDA kernel: flash-decode GQA attention (one query token vs a KV cache).

Replaces the TPU kernel ``repro/kernels/flash_decode.py::flash_decode_padded``
(body ``_flash_decode_kernel``).  The kernel (``csrc/flash_decode.cu``)
walks the cache in tiles with the online-softmax recurrence, one thread
block per (batch row, KV head); its source note says what bounds it on the
card and what its design does about that.  Unlike the TPU kernel it takes
any T >= 1: the ragged last tile is cut in the kernel.

``launches`` counts the kernel launches made through :func:`flash_decode`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0
_fn = None

HEAD_DIMS = (16, 64, 128, 256)
MAX_GROUP = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("flash_decode").flash_decode_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v):
    """Raise unless the kernel takes (q, k, v); return (B, T, Hq, Hkv, D)
    and the batch strides of k and v."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not torch.is_tensor(t) or not t.is_cuda:
            raise ValueError(f"flash_decode: {name} must be a CUDA tensor")
        if t.device != q.device:
            raise ValueError(f"flash_decode: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_decode: {name} is {t.dtype}, q is "
                             f"{q.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} is not 16-byte aligned")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_decode: dtype {q.dtype}, expected float32 "
                         "or bfloat16")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_decode: expected q (B, Hq, D) and k, v "
                         f"(B, T, Hkv, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, D = q.shape
    _, T, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not match "
                         f"k {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {D} not in {HEAD_DIMS}")
    if T < 1 or Hkv < 1 or Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"flash_decode: T={T}, Hq={Hq}, Hkv={Hkv}: needs "
                         f"T >= 1 and Hq / Hkv a whole number <= {MAX_GROUP}")
    if not q.is_contiguous():
        raise ValueError("flash_decode: q is not contiguous")
    strides = []
    for name, t in (("k", k), ("v", v)):
        rows = all(t.stride(i) == s for i, s in ((1, Hkv * D), (2, D), (3, 1))
                   if t.shape[i] > 1)
        bstride = t.stride(0) if B > 1 else T * Hkv * D
        if not rows or bstride % 8:
            raise ValueError(f"flash_decode: {name} rows must be contiguous "
                             "(strides (*, Hkv*D, D, 1), batch stride a "
                             f"multiple of 8); got {t.stride()}")
        strides.append(bstride)
    return B, T, Hq, Hkv, D, strides


def flash_decode(q, k, v):
    """Launch the kernel.  q (B, Hq, D); k, v (B, T, Hkv, D), rows
    contiguous (a view ``cache[:, :T]`` of a longer cache is read in
    place); all float32 or all bfloat16, on one CUDA device.
    Returns (B, Hq, D) float32."""
    global launches
    B, T, Hq, Hkv, D, (k_bstride, v_bstride) = _check(q, k, v)
    dev = q.device
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B, T, Hq, Hkv, D, k_bstride, v_bstride,
                     _DTYPES[q.dtype], dev.index,
                     torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: error {rc}")
    launches += 1
    return out
