"""Device meshes and the masked, int8-compressed reductions of the
episode-parallel search.

Port of the reduction half of ``repro.distributed.dist_search``.  JAX names
a program's devices with ``jax.make_mesh(shape, axis_names)`` and reduces
over named axes inside ``shard_map``; torch has no counterpart, so the port
carries its own mesh, in two forms with one interface: ``shape``,
``axis_names``, ``size`` (the flattened device count), ``lead`` (the
leading dims a per-device value carries), ``device``, and ``psum`` /
``pmax`` / ``pmin`` of a per-device value over a set of axes, which give
every device the result of its group.

  * :class:`VirtualMesh` -- n virtual devices on one torch device.  A
    per-device value is one tensor whose leading dim holds the n devices
    in row-major order, JAX's order for ``P(axes)``.  This is the form
    that runs on the card.
  * :class:`ProcessMesh` -- one ``torch.distributed`` rank a device (rank
    = the flattened row-major index).  A per-device value is the rank's
    own tensor, and a reduction is an ``all_reduce`` over the subgroup of
    the ranks that share the other axes' coordinates.  Gloo CPU ranks test
    it; NCCL spans several GPUs.

:func:`psum_int8`, :func:`masked_psum` and :func:`masked_hierarchical_psum`
keep the reference's semantics on either form.  The ranks' epoch reduces
its gradients through them.  The virtual mesh's epoch does not: it forms
no per-device gradients, and takes the masked mean as one backward pass of
the masked mean loss (one a pod, then :func:`psum_int8` across the pods,
when compressed).  On a :class:`VirtualMesh` the two masked reductions
serve as the reference that the tests hold against the JAX package's
outputs and the gloo ranks against.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import env as env_lib

Tree = Dict[str, torch.Tensor]


class Mesh:
    """What both forms share: the axes and their reductions."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    lead: Tuple[int, ...]

    def _init_axes(self, shape, axis_names):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if (len(self.shape) != len(self.axis_names)
                or len(set(self.axis_names)) != len(self.axis_names)
                or min(self.shape, default=0) < 1):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.axis_names}: need one distinct name a "
                             "dim, each dim >= 1")
        self.size = math.prod(self.shape)

    def _dims(self, axes) -> Tuple[int, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"axes {unknown} are not in the mesh's "
                             f"{self.axis_names}")
        return tuple(sorted({self.axis_names.index(a) for a in axes}))

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._reduce(x, self._dims(axes), "sum")

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._reduce(x, self._dims(axes), "max")

    def pmin(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._reduce(x, self._dims(axes), "min")

    def __repr__(self):
        return (f"{type(self).__name__}({self.shape}, {self.axis_names}, "
                f"device={str(self.device)!r})")


class VirtualMesh(Mesh):
    """``shape`` devices named by ``axis_names``, all on one torch
    ``device`` (the card unless the caller asks for ``"cpu"``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device="cuda"):
        self._init_axes(shape, axis_names)
        self.device = env_lib.resolve_device(device)
        self.lead = (self.size,)

    def _reduce(self, x, dims, op):
        rest = x.shape[1:]
        y = x.reshape(*self.shape, *rest)
        if op == "sum":
            y = torch.sum(y, dim=dims, keepdim=True, dtype=y.dtype)
        elif op == "max":
            y = torch.amax(y, dim=dims, keepdim=True)
        else:
            y = torch.amin(y, dim=dims, keepdim=True)
        return y.expand(*self.shape, *rest).reshape(x.shape)


class ProcessMesh(Mesh):
    """The ranks of an initialised ``torch.distributed`` world as a mesh
    of ``shape`` (its product is the world size).

    Every subset of the axes gets the subgroups of the ranks that share
    the other axes' coordinates, all made here with ``new_group`` in the
    same order on every rank (also those this rank is not in, as
    ``new_group`` requires); a subset that spans the whole world uses the
    default group.  The rank's device is its card under NCCL (rank modulo
    the cards a host has) and the CPU otherwise.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialised "
                               "torch.distributed process group")
        self._init_axes(shape, axis_names)
        world, self.rank = dist.get_world_size(), dist.get_rank()
        if self.size != world:
            raise ValueError(f"mesh {self.shape} has {self.size} devices, "
                             f"the world {world} ranks")
        self.device = env_lib.resolve_device(
            f"cuda:{self.rank % torch.cuda.device_count()}"
            if dist.get_backend() == "nccl" else "cpu")
        self.lead = ()
        ranks = np.arange(world).reshape(self.shape)
        ndim = len(self.shape)
        self._groups = {}
        for k in range(1, ndim + 1):
            for dims in itertools.combinations(range(ndim), k):
                if k == ndim:
                    self._groups[dims] = None
                    continue
                other = [d for d in range(ndim) if d not in dims]
                rows = np.moveaxis(ranks, other, range(len(other))).reshape(
                    -1, math.prod(self.shape[d] for d in dims))
                for row in rows:
                    group = dist.new_group([int(r) for r in row])
                    if self.rank in row:
                        self._groups[dims] = group

    def _reduce(self, x, dims, op):
        if not dims:
            return x
        out = x.detach().clone()
        dist.all_reduce(out, op=getattr(dist.ReduceOp, op.upper()),
                        group=self._groups[dims])
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x``, stacked in rank order: (size, *x.shape)."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.detach().contiguous())
        return torch.stack(parts)

    def check_replicated(self, tensors: Sequence[torch.Tensor],
                         what: str) -> None:
        """Raise unless every rank holds the same bits in ``tensors``."""
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        hi, lo = self.pmax(flat, self.axis_names), self.pmin(
            flat, self.axis_names)
        if not (torch.equal(hi, flat) and torch.equal(lo, flat)):
            raise RuntimeError(f"{what} differ between the ranks of {self}")


def default_mesh(device="cuda") -> Mesh:
    """The reference's default, "all local devices, axis ``data``": the
    world as a :class:`ProcessMesh` when ``torch.distributed`` is
    initialised, else one virtual device on ``device``."""
    if dist.is_available() and dist.is_initialized():
        return ProcessMesh((dist.get_world_size(),), ("data",))
    return VirtualMesh((1,), ("data",), device)


def _per_device(mesh: Mesh, s: torch.Tensor, like: torch.Tensor):
    """A per-device scalar ``s`` (shape ``mesh.lead``) shaped to broadcast
    against a per-device leaf ``like``."""
    return s.reshape(*mesh.lead, *[1] * (like.dim() - len(mesh.lead)))


def psum_int8(mesh: Mesh, tree: Tree, axis) -> Tree:
    """Quantized all-reduce over ``axis``: each leaf scaled by the max over
    the axis of its per-device ``max|x| / 127 + 1e-12``, rounded half to
    even, clipped to [-127, 127], summed as int32 and scaled back.  The
    error is at most half a scale per element and device."""
    def reduce_leaf(x):
        scale = torch.amax(torch.abs(x).reshape(*mesh.lead, -1),
                           dim=-1) / 127.0 + 1e-12
        scale = _per_device(mesh, mesh.pmax(scale, axis), x)
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int32)
        return mesh.psum(q, axis).to(torch.float32) * scale

    return {k: reduce_leaf(x) for k, x in tree.items()}


def masked_psum(mesh: Mesh, tree: Tree, alive: torch.Tensor,
                axes) -> Tree:
    """Straggler-tolerant mean: the sum of the alive devices' leaves over
    ``axes`` divided by ``max(alive count, 1)``.  ``alive`` is the
    per-device flag (shape ``mesh.lead``)."""
    af = alive.to(torch.float32)
    n_alive = torch.clamp_min(mesh.psum(af, axes), 1.0)
    return {k: mesh.psum(x * _per_device(mesh, af, x), axes)
            / _per_device(mesh, n_alive, x) for k, x in tree.items()}


def masked_hierarchical_psum(mesh: Mesh, tree: Tree, alive: torch.Tensor,
                             axes, pod_axis: str = "pod",
                             compress: bool = False) -> Tree:
    """:func:`masked_psum` over ``axes``, with the hop across ``pod_axis``
    compressed when ``compress`` is set and the axis is among ``axes``:
    exact float32 sums within each pod (an empty in-pod set allowed), one
    :func:`psum_int8` across the pods, and a division by the true global
    alive count."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if pod_axis not in axes or not compress:
        return masked_psum(mesh, tree, alive, axes)
    inpod = tuple(a for a in axes if a != pod_axis)
    af = alive.to(torch.float32)
    gsum = {k: x * _per_device(mesh, af, x) for k, x in tree.items()}
    n_local = af
    if inpod:
        gsum = {k: mesh.psum(x, inpod) for k, x in gsum.items()}
        n_local = mesh.psum(af, inpod)
    gsum = psum_int8(mesh, gsum, pod_axis)
    n_alive = torch.clamp_min(mesh.psum(n_local, pod_axis), 1.0)
    return {k: g / _per_device(mesh, n_alive, g) for k, g in gsum.items()}


def alive_flags(mesh: Mesh, straggler_mask: Optional[Sequence[bool]]
                ) -> torch.Tensor:
    """The per-device alive flag (float32, shape ``mesh.lead``) from
    ``straggler_mask``, n bools in flattened device order (None: all
    alive)."""
    if straggler_mask is None:
        mask = np.ones((mesh.size,), bool)
    else:
        mask = np.asarray(straggler_mask, bool).reshape(-1)
        if mask.shape != (mesh.size,):
            raise ValueError(f"straggler_mask has {mask.size} flags, the "
                             f"mesh {mesh.size} devices")
    flags = torch.as_tensor(mask.astype(np.float32), device=mesh.device)
    return flags if mesh.lead else flags[mesh.rank]
