"""Per-architecture sharding rules (DP / FSDP / TP / EP / SP) on a
``DeviceMesh``, and the activation policies of sharded training.

The counterpart of the JAX package's ``distributed/sharding.py``.  The
rule functions are the reference's: parameter placement is rule-based on
the parameter's *path* in the reference tree (``lm.jax_name``, joined with
``/``); the big matmul weights are TP-sharded on ``model`` along their
parallel dimension and FSDP-sharded on ``data`` along the other; experts
put their E dim on ``model`` (EP); norms and scalars replicate.  Every
assignment is guarded by divisibility against the mesh, so no shard is
ever uneven.  A spec is the reference's ``PartitionSpec`` as a plain
tuple: one entry a tensor dim, each an axis name, a tuple of names (one
tensor dim split over several mesh axes, major to minor) or ``None``.
The rule functions read only a mesh's axis names and sizes, so they take a
``DeviceMesh`` or any object with ``axis_names`` and a ``shape`` mapping.

:func:`placements` turns a spec into DTensor placements, one a mesh dim
(``Shard(d)`` / ``Replicate()``); :func:`distribute_model` places a model's
parameters by :func:`param_spec` (the port's parameters are the reference's
per-layer slices: the rule's trailing dims apply, the reference's leading
stack dims are replicated, so the port's per-layer tensor takes the
trailing part of the spec) and :func:`distribute_opt_state` gives each
moment its parameter's placement (the step count is replicated).

:func:`make_policy` builds the :class:`~repro_torch.models.common.
ShardingPolicy` of the ``train``, ``prefill`` and ``decode`` kinds: each
hook redistributes a DTensor to the placement the reference's constraint
names, and leaves a plain tensor alone; its ``weight`` hook gives a
parameter the placement of its use (the FSDP gather, which XLA inserts on
its own).  Decode puts the KV cache's sequence on ``model`` (the
``cache`` hook, :func:`cache_shardings`): each rank attends over its
slice of the cache and the slices' partials are combined across
``model`` (``models/common.py``).  :func:`place_cache` places a fresh
decode cache, :func:`tree_shardings` gives a tree of tensors (the
reference's parameter tree) its layouts by the reference's paths
(:func:`norm_path`), and :func:`sds_with_sharding` makes a fake DTensor of
each leaf of a tree of shapes in its layout (the dry run's stand-ins).  A
layout is a :class:`Sharding`: the reference's spec and the DTensor
placements it makes.
"""
from __future__ import annotations

import math
import re
from typing import Dict, NamedTuple, Tuple

import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.launch.mesh import axis_names
from repro_torch.models import lm
from repro_torch.models.common import ShardingPolicy

MODES = ("tp", "tp_serve", "fsdp", "dp")
Spec = Tuple


def _axis_sizes(mesh) -> Dict[str, int]:
    names = axis_names(mesh)
    if isinstance(getattr(mesh, "shape", None), dict):
        return {n: int(mesh.shape[n]) for n in names}
    return dict(zip(names, (int(s) for s in mesh.shape)))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = _axis_sizes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def norm_path(kp) -> str:
    """A tree key path -> the 'blocks/attn/wq' style string the rules
    match on: the reference's ``norm_path`` over ``torch.utils._pytree``'s
    keys (dict keys, NamedTuple fields, list indices)."""
    parts = []
    for k in kp:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "name"):
            parts.append(str(k.name))
        elif hasattr(k, "idx"):
            parts.append(str(k.idx))
        else:
            parts.append(str(k))
    return "/".join(parts)


def param_path(name: str) -> str:
    """The reference path the rules match for the port's parameter
    ``name``: ``blocks.3.attn.wq`` -> ``blocks/attn/wq``."""
    return "/".join(lm.jax_name(name)[0])


def assign_spec(mesh, shape, prefs) -> Spec:
    """Greedy divisibility-guarded axis assignment.

    prefs: per-dim tuple of candidate axes (each an axis name or tuple of
    names), highest priority first.  An axis is used at most once.
    """
    names_ok = axis_names(mesh)
    used = set()
    spec = []
    for dim, cands in zip(shape, prefs):
        chosen = None
        for ax in cands:
            names = ax if isinstance(ax, tuple) else (ax,)
            if any(n not in names_ok or n in used for n in names):
                continue
            if dim % _axis_size(mesh, ax) == 0 and dim > 0:
                chosen = ax
                used.update(names)
                break
        # Normalize 1-tuples to bare names so specs compare canonically.
        if isinstance(chosen, tuple) and len(chosen) == 1:
            chosen = chosen[0]
        spec.append(chosen)
    return tuple(spec)


# Parameter path -> per-dim axis preferences for the *trailing* dims; any
# leading (stack) dims are replicated (the reference's table).
_RULES = [
    # MoE expert banks: (E, D, F) / (E, F, D) -- EP on model.
    (r"moe.*w_(gate|up)$", (("model",), ("data",), ())),
    (r"moe.*w_down$", (("model",), (), ("data",))),
    (r"moe.*router$", (("data",), ())),
    # Embeddings.
    (r"embed.*tok$", (("model",), ("data",))),
    (r"embed.*unembed$", (("data",), ("model",))),
    # Attention.
    (r"attn.*w[qkv]$", (("data",), ("model",))),
    (r"attn.*wo$", (("model",), ("data",))),
    (r"attn.*b[qkv]$", (("model",),)),
    # Dense MLP.
    (r"mlp.*w_(gate|up)$", (("data",), ("model",))),
    (r"mlp.*w_down$", (("model",), ("data",))),
    # Mamba: in_proj is row-parallel TP (irregular output dim), out_proj
    # column-parallel.
    (r"mamba.*in_proj$", (("model",), ("data",))),
    (r"mamba.*out_proj$", (("model",), ("data",))),
    (r"mamba.*conv_[wb]$", ((), ("model",))),
]


def _fsdp_spec(mesh, shape) -> Spec:
    """ZeRO-3 placement: shard the largest divisible dim over ALL mesh axes
    (merged); no tensor parallelism.  Small/indivisible leaves replicate."""
    axes = axis_names(mesh)
    n = _axis_size(mesh, axes)
    if not shape or math.prod(shape) < 2 * n:
        return ()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % n == 0:
            spec = [None] * len(shape)
            spec[i] = axes
            return tuple(spec)
    return ()


def param_spec(mesh, path: str, shape, mode: str = "tp") -> Spec:
    """mode 'tp' (baseline): TP on model + FSDP on data, per _RULES.
    mode 'tp_serve': TP on model only -- params replicated across the data
                     axis (serving replicas re-gather nothing per step).
    mode 'fsdp': pure ZeRO-3 over the merged mesh (no TP).
    mode 'dp':   fully replicated parameters (pure data parallel)."""
    if mode not in MODES:
        raise ValueError(f"unknown sharding mode {mode!r}; one of {MODES}")
    shape = tuple(shape)
    if mode == "dp":
        return ()
    if mode == "fsdp":
        return _fsdp_spec(mesh, shape)
    for pat, prefs in _RULES:
        if re.search(pat, path):
            n_lead = len(shape) - len(prefs)
            if n_lead < 0:
                return ()
            full = tuple(() for _ in range(n_lead)) + tuple(prefs)
            if mode == "tp_serve":
                full = tuple(
                    tuple(ax for ax in cands
                          if ax not in ("data", "pod")
                          and not (isinstance(ax, tuple)
                                   and set(ax) & {"data", "pod"}))
                    for cands in full)
            return assign_spec(mesh, shape, full)
    return ()  # norms, scalars, biases without rules: replicate


def reference_shape(model, name: str) -> Tuple[int, ...]:
    """The reference leaf's shape of the port's parameter ``name``: the
    port's per-layer shape behind the stack's leading dims."""
    path, idx = lm.jax_name(name)
    p = model.get_parameter(name)
    if not idx:
        return tuple(p.shape)
    top = name.split(".")[0]
    stack = getattr(model, top)
    lead = [len(stack)] + ([len(stack[0])] if len(idx) == 2 else [])
    return tuple(lead) + tuple(p.shape)


def model_spec(mesh, model, name: str, mode: str = "tp") -> Spec:
    """The spec of the port's parameter ``name``: the reference leaf's spec
    without its leading stack dims, which the rules never shard.  Only
    fsdp's largest-dim rule may pick a stack dim (the reference then
    splits the layers over the mesh, a layer whole on its ranks), which a
    per-layer tensor cannot express: the port then applies the same rule
    to the per-layer shape."""
    shape = reference_shape(model, name)
    spec = param_spec(mesh, param_path(name), shape, mode)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    p_shape = tuple(model.get_parameter(name).shape)
    n_lead = len(shape) - len(p_shape)
    if any(s is not None for s in spec[:n_lead]):
        if mode != "fsdp":
            raise ValueError(f"{name}: a rule shards a stack dim ({spec})")
        return _fsdp_spec(mesh, p_shape) or (None,) * len(p_shape)
    return spec[n_lead:]


class Sharding(NamedTuple):
    """A tensor's layout on a mesh: the reference's ``PartitionSpec`` as a
    tuple (``spec``) and the DTensor placements it makes."""

    spec: Spec
    placements: tuple


def _shape(leaf):
    return tuple(getattr(leaf, "shape", ()))


def _canonical(spec) -> Spec:
    """``spec`` with 1-tuples as bare names, as ``PartitionSpec``
    normalizes them."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _sharding(mesh, spec, leaf) -> Sharding:
    return Sharding(_canonical(spec),
                    placements(mesh, spec, len(_shape(leaf))))


def _map_with_path(fn, tree):
    """``tree`` with each leaf replaced by ``fn(path string, leaf)`` (an
    absent part, None, stays None)."""
    flat, treedef = pytree.tree_flatten_with_path(tree)
    return pytree.tree_unflatten(
        [None if leaf is None else fn(norm_path(kp), leaf)
         for kp, leaf in flat], treedef)


def tree_shardings(mesh, tree, mode: str = "tp"):
    """The :class:`Sharding` of every leaf of ``tree`` (nested dicts,
    NamedTuples and lists of tensors or of anything with a ``shape``, such
    as the reference's parameter tree), by :func:`param_spec` on its path
    (:func:`norm_path`), in the tree's structure."""
    return _map_with_path(
        lambda path, leaf: _sharding(
            mesh, param_spec(mesh, path, _shape(leaf), mode), leaf), tree)


def _torch_dtype(dt) -> torch.dtype:
    """A torch dtype from a torch, numpy or JAX dtype (or its name)."""
    if isinstance(dt, torch.dtype):
        return dt
    return getattr(torch, getattr(dt, "name", None) or str(dt))


def sds_with_sharding(mesh, tree, mode: str = "tp"):
    """A fake DTensor for each leaf of ``tree`` (anything with a ``shape``
    and a ``dtype``: the reference's ``ShapeDtypeStruct`` s, meta or fake
    tensors), placed by :func:`param_spec` on its path in ``mode``, on
    ``mesh``'s device type: the counterpart of the reference's
    ``ShapeDtypeStruct`` s that carry their shardings.  The leaves are made
    under the active ``FakeTensorMode`` (a new one if none is active), so
    nothing is allocated; each rank's local tensor is its shard."""
    from torch._guards import active_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = active_fake_mode() or FakeTensorMode()
    sizes = [mesh.size(i) for i in range(mesh.ndim)]

    def leaf(path, x):
        shape = tuple(x.shape)
        pl = placements(mesh, param_spec(mesh, path, shape, mode),
                        len(shape))
        local = list(shape)
        for size, p in zip(sizes, pl):
            if p.is_shard():
                local[p.dim] //= size
        with fake:
            t = torch.empty(local, dtype=_torch_dtype(x.dtype),
                            device=mesh.device_type)
            return DTensor.from_local(t, mesh, pl, run_check=False,
                                      shape=torch.Size(shape),
                                      stride=torch.empty(shape,
                                                         device="meta")
                                      .stride())

    return _map_with_path(leaf, tree)


def placements(mesh, spec: Spec, ndim: int):
    """DTensor placements of ``spec`` on ``mesh``: one a mesh dim,
    ``Shard(d)`` where the spec puts that axis on tensor dim ``d``, else
    ``Replicate()``.  A dim split over a tuple of axes must name them in
    the mesh's order: DTensor splits a dim over several mesh dims in
    mesh-dim order, which is then the tuple's major-to-minor order, so
    each rank holds the block that the JAX device at the same mesh
    coordinates holds."""
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} splits over {axes}, "
                             f"not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def distribute_model(model, mesh, mode: str = "tp"):
    """Replace every parameter of ``model`` (full tensors, the same on
    every rank) by a DTensor parameter placed by :func:`model_spec`, one
    at a time, so that each whole tensor is freed once its shards are
    made."""
    for name in [n for n, _ in model.named_parameters()]:
        p = model.get_parameter(name)
        spec = model_spec(mesh, model, name, mode)
        dt = distribute_tensor(p.detach(), mesh,
                               placements(mesh, spec, p.dim()))
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        setattr(mod, leaf, torch.nn.Parameter(dt, requires_grad=False))


def distribute_opt_state(opt_state, model):
    """An optimizer state of full tensors placed as its parameters are:
    each moment takes its parameter's placement, the step is replicated."""
    named = dict(model.named_parameters())
    mesh = next(iter(named.values())).device_mesh
    place = lambda k, t: distribute_tensor(t, mesh, named[k].placements)
    return type(opt_state)(
        distribute_tensor(opt_state.step, mesh,
                          [Replicate()] * mesh.ndim),
        {k: place(k, v) for k, v in opt_state.mu.items()},
        {k: place(k, v) for k, v in opt_state.nu.items()})


def full_state(tensors):
    """Whole tensors of a dict of (possibly DTensor) tensors, gathered on
    every rank (checkpoints are written whole, so they restore onto any
    mesh)."""
    return {k: (v.full_tensor() if isinstance(v, DTensor) else v)
            for k, v in tensors.items()}


# ---------------------------------------------------------------------------
# Activation policies.
# ---------------------------------------------------------------------------
def _batch_axis(mesh, batch: int, *, include_model: bool = False):
    """Largest data-parallel axis combo that divides the global batch."""
    names = axis_names(mesh)
    cands = (("pod", "data", "model"), ("data", "model"),
             ("pod", "data"), ("data",), ("pod",)) if include_model else \
            (("pod", "data"), ("data",), ("pod",))
    for cand in cands:
        if all(a in names for a in cand):
            if batch % _axis_size(mesh, cand) == 0:
                return cand
    return None


def batch_spec(mesh, batch: int, *, mode: str = "tp") -> Spec:
    """The spec of a (B, T) batch: B over the data axes (every axis in
    fsdp / dp), the reference's ``batch_sharding``."""
    dp = _batch_axis(mesh, batch, include_model=mode in ("fsdp", "dp"))
    if isinstance(dp, tuple) and len(dp) == 1:
        dp = dp[0]             # canonical, as PartitionSpec normalizes it
    return (dp, None)


def batch_sharding(mesh, batch: int, *, mode: str = "tp"):
    """DTensor placements of a (B, T) batch on ``mesh``."""
    return placements(mesh, batch_spec(mesh, batch, mode=mode), 2)


def place_batch(batch, mesh, *, mode: str = "tp"):
    """Each (B, ...) tensor of ``batch`` (the same on every rank) as a
    DTensor placed by :func:`batch_sharding` on its leading dim."""
    out = {}
    for k, v in batch.items():
        spec = (batch_spec(mesh, v.shape[0], mode=mode)[0],)
        out[k] = distribute_tensor(v, mesh, placements(mesh, spec, v.dim()))
    return out


def _redistribute(x, mesh, spec):
    """``x`` redistributed to ``spec`` if it is a DTensor (a Partial sum is
    reduced on the way); a plain tensor is left alone."""
    if not isinstance(x, DTensor):
        return x
    want = placements(mesh, spec, x.dim())
    if tuple(x.placements) == want:
        return x
    if any(type(pl).__name__.endswith("MaskPartial")
           for pl in x.placements):
        # An embedding's masked partial sum (a replicated token batch, as
        # decode feeds it) is reduced first: DTensor cannot reduce it and
        # split the batch in one redistribution (its mask keeps the
        # unsplit shape).
        x = x.redistribute(mesh, tuple(
            Replicate() if pl.is_partial() else pl for pl in x.placements))
        if tuple(x.placements) == want:
            return x
    return x.redistribute(mesh, want)


def _gather_weight(keep_model: bool):
    """The ``weight`` hook: a parameter's placement at its use.  FSDP
    shards (over the data axes, or every axis in fsdp) are gathered;
    under TP the ``model`` sharding stays (the product runs on it)."""
    def weight(w):
        if not isinstance(w, DTensor):
            return w
        names = w.device_mesh.mesh_dim_names
        want = tuple(pl if keep_model and n == "model" else Replicate()
                     for n, pl in zip(names, w.placements))
        if want == tuple(w.placements):
            return w
        return w.redistribute(w.device_mesh, want)
    return weight


def make_policy(mesh, *, batch: int, kind: str = "train",
                sp: bool = True, mode: str = "tp") -> ShardingPolicy:
    """Activation-sharding hooks for a given input shape.

    mode "tp"/"tp_serve" (baseline): residual stream is
    sequence-parallel on ``model`` (when divisible) for train/prefill,
    heads/ffn TP on ``model``; decode uses the KV-cache layout (the
    ``cache`` hook: sequence on ``model``, batch on the data axes).
    mode "fsdp"/"dp": every mesh axis carries batch -- activations shard
    dim 0 only; layer math is fully local (ZeRO-3 weight gathers /
    pure-DP gradient reduction are the only collectives).
    """
    if mode not in MODES:
        raise ValueError(f"unknown sharding mode {mode!r}; one of {MODES}")
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown kind {kind!r}")
    seq = sp and kind != "decode"
    if mode in ("fsdp", "dp"):
        return _batch_only_policy(mesh, batch)
    dp = _batch_axis(mesh, batch)
    msize = _axis_size(mesh, "model")
    cons = lambda x, spec: _redistribute(x, mesh, spec)

    def resid(x):
        if x.ndim != 3:
            return x
        seq_ok = seq and x.shape[1] % msize == 0
        return cons(x, (dp, "model" if seq_ok else None, None))

    def heads(x):  # (B, T, H, hd): q stays sequence-sharded in SP mode
        if x.ndim != 4:
            return x
        if seq and x.shape[1] % msize == 0:
            return cons(x, (dp, "model", None, None))
        if x.shape[2] % msize == 0:
            return cons(x, (dp, None, "model", None))
        return x

    def kv_full(x):  # (B, S, Kv, hd): sequence-complete per device
        if x.ndim != 4 or kind == "decode":
            return x
        return cons(x, (dp, None, None, None))

    def ssm_x(x):  # (B, T, H, P): full sequence; heads on model if divisible
        if x.ndim != 4:
            return x
        hax = "model" if x.shape[2] % msize == 0 else None
        return cons(x, (dp, None, hax, None))

    def ffn(x):    # (B, T, F)
        if x.ndim != 3 or x.shape[2] % msize:
            return x
        return cons(x, (dp, None, "model"))

    def experts(x):  # (n_groups, E, C, D)
        if x.ndim != 4 or x.shape[1] % msize:
            return x
        ng = dp if (dp and x.shape[0] % _axis_size(mesh, dp) == 0) else None
        return cons(x, (ng, "model", None, None))

    dpm = (tuple(dp) if dp else ()) + ("model",)

    def dispatch(x):  # (n_groups, g, E*C)
        if x.ndim != 3 or x.shape[0] % _axis_size(mesh, dpm):
            return x
        return cons(x, (dpm, None, None))

    def experts_flat(x):  # (n_groups, E*C, D/F): same local layout
        if x.ndim != 3 or x.shape[0] % _axis_size(mesh, dpm):
            return x
        return cons(x, (dpm, None, None))

    def logits(x):  # (B, T, V)
        if x.ndim != 3 or x.shape[2] % msize:
            return x
        return cons(x, (dp, None, "model"))

    def cache(x):  # (B, Tmax, Kv, hd): sequence on model (flash-decode)
        if x.ndim != 4 or x.shape[1] % msize:
            return x
        bax = dp if (dp and x.shape[0] % _axis_size(mesh, dp) == 0) else None
        return cons(x, (bax, "model", None, None))

    return ShardingPolicy(resid=resid, heads=heads, kv_full=kv_full,
                          ffn=ffn, experts=experts, dispatch=dispatch,
                          experts_flat=experts_flat, ssm_x=ssm_x,
                          logits=logits, cache=cache,
                          weight=_gather_weight(True), mesh=mesh)


def _batch_only_policy(mesh, batch: int) -> ShardingPolicy:
    """fsdp/dp activation policy: dim 0 (batch or group) over ALL axes."""
    dp = _batch_axis(mesh, batch, include_model=True)

    def lead(x):
        if (dp is None or x.ndim < 1
                or x.shape[0] % _axis_size(mesh, dp)):
            return x
        return _redistribute(x, mesh, (dp,) + (None,) * (x.ndim - 1))

    return ShardingPolicy(resid=lead, heads=lead, kv_full=lead, ffn=lead,
                          experts=lead, dispatch=lead, experts_flat=lead,
                          ssm_x=lead, logits=lead, cache=lead,
                          weight=_gather_weight(False), mesh=mesh)


def cache_spec(mesh, path: str, shape, *, batch: int) -> Spec:
    """The reference's spec of the decode-cache leaf at ``path`` (the
    flash-decode layout): attention and cross K/V (sites, B, T, Kv, hd)
    put the sequence on ``model`` and the batch on the data axes where
    they divide; a Mamba state (..., B, H, P, S) its heads on ``model``,
    a conv tail (..., B, W - 1, C) its channels; anything else
    replicates.  The port's per-layer Mamba tensors are the reference's
    stacked leaves without their leading dims, which the rule never
    shards, so their spec is the trailing part of the reference's."""
    shp = tuple(shape)
    if not shp:
        return ()
    dp = _batch_axis(mesh, batch)
    msize = _axis_size(mesh, "model")
    if re.search(r"attn_[kv]|cross_[kv]", path) and len(shp) == 5:
        bax = dp if (dp and shp[1] % _axis_size(mesh, dp) == 0) else None
        sax = "model" if shp[2] % msize == 0 else None
        return (None, bax, sax, None, None)
    if re.search(r"mamba.*ssm", path):
        prefs = tuple(() for _ in shp[:-4]) + (
            (("pod", "data"), ("data",)), ("model",), (), ())
        return assign_spec(mesh, shp, prefs)
    if re.search(r"mamba.*conv", path):
        prefs = tuple(() for _ in shp[:-3]) + (
            (("pod", "data"), ("data",)), (), ("model",))
        return assign_spec(mesh, shp, prefs)
    return ()


def cache_shardings(mesh, cache, *, batch: int):
    """The :class:`Sharding` of every tensor of a decode cache (the
    port's ``lm.Cache``, or any tree of its paths: ``attn_k`` / ``attn_v``
    / ``cross_k`` / ``cross_v``, ``mamba/<layer>/conv`` and
    ``mamba/<layer>/ssm``), in the cache's structure (:func:`cache_spec`;
    ``pos`` and absent parts replicate)."""
    return _map_with_path(
        lambda path, leaf: _sharding(
            mesh, cache_spec(mesh, path, _shape(leaf), batch=batch), leaf),
        cache)


def place_cache(cache, mesh, *, batch: int):
    """A fresh decode cache (plain tensors, the same on every rank) with
    each tensor distributed by :func:`cache_shardings`; ``pos`` stays a
    host int."""
    shardings = cache_shardings(mesh, cache, batch=batch)
    flat, treedef = pytree.tree_flatten(cache)
    places = pytree.tree_leaves(shardings,
                                is_leaf=lambda x: isinstance(x, Sharding))
    return pytree.tree_unflatten(
        [distribute_tensor(t, mesh, sh.placements)
         if isinstance(t, torch.Tensor) else t
         for t, sh in zip(flat, places)], treedef)
