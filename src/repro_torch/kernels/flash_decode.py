"""CUDA kernel: flash-decode GQA attention (one query token vs a KV cache).

Replaces the TPU kernel ``repro/kernels/flash_decode.py::flash_decode_padded``
(body ``_flash_decode_kernel``).  The kernel (``csrc/flash_decode.cu``)
splits the cache across thread blocks (flash-decoding): each block walks
its share of T in tiles with the online-softmax recurrence and writes a
partial (acc, m, l) per query row, and a second kernel combines the
partials in a fixed order.  :func:`plan_splits` chooses how many splits;
with one split the first kernel writes the output itself.  Its source
note says what bounds it on the card and what its design does about
that.  Unlike the TPU kernel it takes any T >= 1: the ragged last tile is
cut in the kernel.

A cache sharded on its sequence (sharded decode) runs the two kernels
apart: :func:`flash_decode_partials` runs the split kernel on one rank's
slice and returns its partials, and :func:`flash_decode_combine` runs the
combine kernel on the partials of every slice, gathered in sequence
order.  A slice with no valid key gives the neutral partial (acc = 0,
m = -inf, l = 0) without a launch, which the combine weighs by 0.

``build.launches["flash_decode"]`` counts the calls of
:func:`flash_decode` that launched the kernel (one per attention);
``build.launches["flash_decode_combine"]`` counts the combine kernel's
launches (one per call of :func:`flash_decode` with more than one split,
and one per call of :func:`flash_decode_combine`);
``build.launches["flash_decode_partials"]`` counts the split kernel's
launches by :func:`flash_decode_partials`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_fn = None
_partials_fn = None
_combine_fn = None

HEAD_DIMS = (16, 64, 128, 256)
MAX_GROUP = 16
TILE = 32            # keys per tile, kTile in csrc/flash_decode.cu
MAX_SPLITS = 256     # kMaxSplits there
# Blocks per SM the plan aims for: at (8, 16, 2, 128) bf16 five blocks fit
# on one SM at once (tools/tune_flash_decode.py times other choices), and
# the most tiles a split walks when the cache is long.
BLOCKS_PER_SM = 4
MAX_SPLIT_TILES = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Checked shapes and their plans, by (dtype, device, shape, stride) of
# q, k and v; alignment is checked on every call.
_plans: dict = {}
_sm_counts: dict = {}


def plan_splits(B, Hkv, T, sms, max_splits=MAX_SPLITS):
    """How to split T keys across blocks: ``(splits, tiles_per_split)``.

    Split s takes keys ``[s * K, min(T, (s + 1) * K))`` with
    ``K = tiles_per_split * TILE``: the splits cover [0, T) in order,
    start on a tile, and each has at least one key.  Enough splits to make
    about ``BLOCKS_PER_SM * sms`` blocks, none when the B * Hkv blocks
    alone fill ~2 waves of ``sms`` SMs; and, however large B * Hkv, enough
    that no split walks more than ``MAX_SPLIT_TILES`` tiles, so that a
    long cache ends in many short blocks and not in a long last wave.  At
    most one split per tile and at most ``max_splits`` (``MAX_SPLITS``
    unless a sharded caller must leave room for its other ranks' splits
    in one combine).
    """
    if T < 1 or B * Hkv < 1:
        raise ValueError(f"plan_splits: needs T >= 1 and B * Hkv >= 1, got "
                         f"T={T}, B={B}, Hkv={Hkv}")
    tiles = -(-T // TILE)
    bh = B * Hkv
    fill = 1 if bh >= 2 * sms else -(-BLOCKS_PER_SM * sms // bh)
    want = min(tiles, max_splits,
               max(fill, -(-tiles // MAX_SPLIT_TILES)))
    per = -(-tiles // want)
    return -(-tiles // per), per


def shard_width(shards, rows):
    """How many partials a query row each of ``shards`` ranks gives for
    its ``rows``-row slice of a cache sharded on its sequence: at most
    one split a tile, and few enough that all the ranks' partials fit one
    combine (``MAX_SPLITS``).  Every rank pads its splits to this width,
    so their partials line up for the gather."""
    return max(1, min(MAX_SPLITS // shards, -(-rows // TILE)))


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("flash_decode").flash_decode_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _partials_launcher():
    global _partials_fn
    if _partials_fn is None:
        fn = build.load("flash_decode").flash_decode_partials_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _partials_fn = fn
    return _partials_fn


def _combine_launcher():
    global _combine_fn
    if _combine_fn is None:
        fn = build.load("flash_decode").flash_decode_combine_launch
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _combine_fn = fn
    return _combine_fn


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


def _plan(q, k, v, max_splits=MAX_SPLITS):
    """The checked shape and split plan of (q, k, v), from the cache when
    their dtypes, devices, shapes and strides were seen before."""
    try:
        key = tuple((t.dtype, t.device, t.shape, t.stride())
                    for t in (q, k, v)) + (max_splits,)
    except AttributeError:          # not a tensor: _check says so
        key = None
    plan = _plans.get(key)
    if plan is None:
        B, T, Hq, Hkv, D, strides = _check(q, k, v)
        dev = q.device
        sms = _sm_counts.get(dev.index)
        if sms is None:
            sms = _sm_counts[dev.index] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        S, per = plan_splits(B, Hkv, T, sms, max_splits) if B else (1, 1)
        plan = (B, T, Hq, Hkv, D, strides, S, per * TILE)
        if len(_plans) > 4096:
            _plans.clear()
        _plans[key] = plan
    return plan


def _check_aligned(*tensors):
    for name, t in zip(("q", "k", "v"), tensors):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} is not 16-byte aligned")


def flash_decode(q, k, v):
    """Launch the kernel.  q (B, Hq, D); k, v (B, T, Hkv, D), rows
    contiguous (a view ``cache[:, :T]`` of a longer cache is read in
    place); all float32 or all bfloat16, on one CUDA device.
    Returns (B, Hq, D) float32."""
    B, T, Hq, Hkv, D, (k_bstride, v_bstride), S, keys = _plan(q, k, v)
    _check_aligned(q, k, v)
    dev = q.device
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    ws = (torch.empty((B, Hq, S, D + 2), dtype=torch.float32, device=dev)
          if S > 1 else None)
    stream = build.stream(dev.index)
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     None if ws is None else ws.data_ptr(),
                     B, T, Hq, Hkv, D, k_bstride, v_bstride, S, keys,
                     _DTYPES[q.dtype], dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: error {rc}")
    build.count("flash_decode", stream)
    if S > 1:
        build.count("flash_decode_combine", stream)
    return out


def flash_decode_partials(q, k, v, max_splits=MAX_SPLITS):
    """The split kernel alone on (q, k, v), as :func:`flash_decode` takes
    them, with any T >= 0 (one rank's slice of a sharded cache): each
    split's unnormalised partial per query row, (B, Hq, S, D + 2) float32
    (``acc`` over D, then ``m`` and ``l``), S from :func:`plan_splits`
    with at most ``max_splits`` splits, also when S is 1.  With T = 0 no
    kernel runs: one neutral partial a row (acc = 0, m = -inf, l = 0)."""
    if torch.is_tensor(k) and k.dim() == 4 and k.shape[1] == 0:
        if not (torch.is_tensor(q) and q.is_cuda and q.dim() == 3):
            raise ValueError("flash_decode_partials: q must be a (B, Hq, D) "
                             "CUDA tensor")
        return ref.neutral_partials(q.shape[0], q.shape[1], 1, q.shape[2],
                                    q.device)
    if not 1 <= max_splits <= MAX_SPLITS:
        raise ValueError(f"flash_decode_partials: max_splits {max_splits} "
                         f"outside [1, {MAX_SPLITS}]")
    B, T, Hq, Hkv, D, (k_bstride, v_bstride), S, keys = _plan(
        q, k, v, max_splits)
    _check_aligned(q, k, v)
    dev = q.device
    ws = torch.empty((B, Hq, S, D + 2), dtype=torch.float32, device=dev)
    if B == 0:
        return ws
    stream = build.stream(dev.index)
    rc = _partials_launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              ws.data_ptr(), B, T, Hq, Hkv, D, k_bstride,
                              v_bstride, S, keys, _DTYPES[q.dtype],
                              dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode_partials kernel launch failed: "
                           f"error {rc}")
    build.count("flash_decode_partials", stream)
    return ws


def flash_decode_combine(parts):
    """The combine kernel on partials (B, Hq, S, D + 2) float32 (S <=
    ``MAX_SPLITS``), contiguous on one CUDA device, summed in the order
    s = 0, 1, ...: returns (B, Hq, D) float32.  Neutral partials add
    nothing; each row needs one partial that is not neutral."""
    if not torch.is_tensor(parts) or not parts.is_cuda:
        raise ValueError("flash_decode_combine: parts must be a CUDA tensor")
    if parts.dtype != torch.float32 or parts.dim() != 4:
        raise ValueError(f"flash_decode_combine: expected (B, Hq, S, D + 2) "
                         f"float32, got {parts.dtype} "
                         f"{tuple(parts.shape)}")
    B, Hq, S, D2 = parts.shape
    if not 1 <= S <= MAX_SPLITS or D2 < 3:
        raise ValueError(f"flash_decode_combine: S={S} outside [1, "
                         f"{MAX_SPLITS}] or D + 2 = {D2} < 3")
    if not parts.is_contiguous():
        raise ValueError("flash_decode_combine: parts is not contiguous")
    dev = parts.device
    out = torch.empty((B, Hq, D2 - 2), dtype=torch.float32, device=dev)
    if B * Hq == 0:
        return out
    stream = build.stream(dev.index)
    rc = _combine_launcher()(parts.data_ptr(), out.data_ptr(), B * Hq, S,
                             D2 - 2, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode_combine kernel launch failed: "
                           f"error {rc}")
    build.count("flash_decode_combine", stream)
    return out
