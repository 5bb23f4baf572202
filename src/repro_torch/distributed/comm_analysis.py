"""The port's counterpart of ``repro/distributed/hlo_analysis.py``:
collective-traffic accounting and the roofline terms of one step.

The reference parses the compiled HLO for its collectives.  The port has
no HLO: a step runs eagerly, and :class:`StepRecorder`, a
``TorchDispatchMode``, records what rank 0 dispatches while it runs --
each ``_c10d_functional`` / ``c10d_functional`` collective (DTensor's
redistributions issue these), each ``c10d`` collective or send of the
hand-written code (``dist.all_gather_into_tensor`` in sharded decode, the
pipeline's ``send``), the FLOPs of every operation by
``torch.utils.flop_counter``'s formulas, the bytes every operation reads
and writes, and the calls of the port's own operators (``repro_torch::``,
flash decode's).  It lets DTensor turn each operation into its local
ones first, so every count is rank 0's own: its shards, not the global
tensors.  :func:`collective_stats` sums the collectives by kind with the
reference's rules: a collective's bytes are its result's; a
reduce-scatter counts its operand (the result times the group size),
since the wire moves the whole reduced tensor; an all-reduce is wired
twice (:data:`WIRE_FACTOR`, its reduce and broadcast phases); the
completion of an asynchronous collective (``wait_tensor``, the
reference's ``-done``) is not counted again.  A point-to-point ``send``
counts as a collective-permute, the reference pipeline's transfer, and
its ``recv`` is the same transfer seen from the other end.

Two of the reference's corrections have no counterpart.  Loop scaling
(``computation_multipliers``): XLA prints a ``while`` body once, while an
eager Python loop runs, and is recorded, every trip.  The f32 -> bf16
wire correction: the reference's CPU compile upcasts bf16 collectives to
f32, while the port's collectives carry the program's own dtypes.

The roofline's denominators are the card's own, from NVIDIA's H100 SXM
data sheet, for an NVIDIA H100 80GB HBM3 at 700 W: 989e12 FLOP/s dense
bf16, 3.35e12 B/s of HBM, and 50e9 B/s for collectives, one 400 Gb/s NDR
port a card, the rate between hosts.  NVLink's 450 GB/s each way holds
only inside an 8-card host, and each 16-wide axis of the production
meshes (``launch/mesh.py``) crosses hosts.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, Tuple

import torch
from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}

# NVIDIA H100 80GB HBM3 at 700 W (the H100 SXM data sheet).
PEAK_FLOPS_BF16 = 989e12          # dense bf16, per card
HBM_BW = 3.35e12                  # B/s per card
NET_BW = 50e9                     # B/s per card: one 400 Gb/s NDR port

# (namespace, op name) -> (kind, where its counted bytes are): "out" the
# result, or the index of the argument that holds them.
_COLLECTIVE_OPS = {}
for _ns in ("_c10d_functional", "c10d_functional"):
    _COLLECTIVE_OPS.update({
        (_ns, "all_reduce"): ("all-reduce", 0),
        (_ns, "all_reduce_"): ("all-reduce", 0),
        (_ns, "all_reduce_coalesced"): ("all-reduce", 0),
        (_ns, "all_reduce_coalesced_"): ("all-reduce", 0),
        (_ns, "all_gather_into_tensor"): ("all-gather", "out"),
        (_ns, "all_gather_into_tensor_out"): ("all-gather", "out"),
        (_ns, "all_gather_into_tensor_coalesced"): ("all-gather", "out"),
        (_ns, "reduce_scatter_tensor"): ("reduce-scatter", 0),
        (_ns, "reduce_scatter_tensor_coalesced"): ("reduce-scatter", 0),
        (_ns, "all_to_all_single"): ("all-to-all", "out"),
    })
_COLLECTIVE_OPS.update({
    ("c10d", "allreduce_"): ("all-reduce", 0),
    ("c10d", "allreduce_coalesced_"): ("all-reduce", 0),
    ("c10d", "_allgather_base_"): ("all-gather", 0),
    ("c10d", "allgather_"): ("all-gather", 0),
    ("c10d", "allgather_into_tensor_coalesced_"): ("all-gather", 0),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", 1),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", 1),
    ("c10d", "reduce_scatter_tensor_coalesced_"): ("reduce-scatter", 1),
    ("c10d", "alltoall_base_"): ("all-to-all", 0),
    ("c10d", "alltoall_"): ("all-to-all", 0),
    ("c10d", "send"): ("collective-permute", 0),
})
# Operations that move no bytes of their own.
_NO_TRAFFIC = {("_c10d_functional", "wait_tensor"),
               ("c10d_functional", "wait_tensor"), ("c10d", "recv_")}
# Metadata queries, left to the next handler as FlopCounterMode leaves
# them.
_METADATA = {torch.ops.aten.sym_is_contiguous.default,
             torch.ops.aten.is_contiguous.default,
             torch.ops.aten.is_contiguous.memory_format,
             torch.ops.aten.is_strides_like_format.default,
             torch.ops.aten.is_non_overlapping_and_dense.default,
             torch.ops.aten.size.default,
             torch.ops.aten.sym_size.default,
             torch.ops.aten.stride.default,
             torch.ops.aten.sym_stride.default,
             torch.ops.aten.storage_offset.default,
             torch.ops.aten.sym_storage_offset.default,
             torch.ops.aten.numel.default,
             torch.ops.aten.sym_numel.default,
             torch.ops.aten.dim.default,
             torch.ops.prim.layout.default}


def tensor_bytes(x) -> int:
    """Bytes of every tensor in ``x`` (a tensor, or nested lists, tuples
    and dicts of them; anything else counts 0)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(v) for v in x)
    if isinstance(x, dict):
        return sum(tensor_bytes(v) for v in x.values())
    return 0


_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd
_DECOMPOSES: Dict = {}


def _decomposes(func) -> bool:
    """Whether ``func.decompose`` would run a decomposition (as
    ``FlopCounterMode`` tries one for every operation), memoized."""
    can = _DECOMPOSES.get(func)
    if can is None:
        can = _DECOMPOSES[func] = (
            _COMPOSITE in func.py_kernels
            or torch._C._dispatch_has_kernel_for_dispatch_key(func.name(),
                                                              _COMPOSITE))
    return can


def _name(func) -> Tuple[str, str]:
    return func.namespace, func._overloadpacket.__name__


class StepRecorder(TorchDispatchMode):
    """Records what rank 0 dispatches while a step runs under it:
    ``flops`` (``torch.utils.flop_counter``'s formulas on the local
    operations, as ``FlopCounterMode`` counts them), ``bytes`` (each
    operation's input and output tensors but views' and collective
    completions'), ``collectives`` ((kind, bytes) a collective, module
    docstring) and ``calls`` (calls of each ``repro_torch::`` operator).

    DTensor operations are left to DTensor (NotImplemented), which runs
    their local operations under this mode.  Operations that DTensor's
    sharding propagation runs under a fake mode of its own are not the
    step's, and are not counted (as ``MemTracker`` skips them)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = []
        self.calls = Counter()
        self._fake_on_entry = None

    def __enter__(self):
        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def _foreign(self, args, kwargs) -> bool:
        """Whether an operation works on fake tensors of another fake
        mode than the step's (DTensor's sharding propagation)."""
        for a in (*args, *kwargs.values()):
            for t in (a if isinstance(a, (list, tuple)) else (a,)):
                if (isinstance(t, FakeTensor)
                        and t.fake_mode is not self._fake_on_entry):
                    return True
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types) or func in _METADATA:
            return NotImplemented
        if self._foreign(args, kwargs):
            return func(*args, **kwargs)
        if func is not torch.ops.prim.device.default and _decomposes(func):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        packet, name = func._overloadpacket, _name(func)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += (tensor_bytes(args) + tensor_bytes(kwargs)
                           + tensor_bytes(out))
        coll = _COLLECTIVE_OPS.get(name)
        if coll is not None:
            kind, where = coll
            self.collectives.append(
                (kind, tensor_bytes(out if where == "out" else args[where])))
        if name[0] == "repro_torch":
            self.calls[name[1]] += 1
        return out


def collective_stats(collectives: Iterable[Tuple[str, float]]
                     ) -> Dict[str, float]:
    """Per-device collective bytes by kind, ``total_bytes``,
    ``total_wire_bytes`` (each kind times :data:`WIRE_FACTOR`) and
    ``n_<kind>``, from the (kind, bytes) pairs a :class:`StepRecorder`
    recorded on rank 0 (its ``collectives``)."""
    out: Dict[str, float] = {c: 0.0 for c in COLLECTIVES}
    counts: Dict[str, int] = {c: 0 for c in COLLECTIVES}
    for kind, nbytes in collectives:
        out[kind] += nbytes
        counts[kind] += 1
    out["total_bytes"] = sum(out[c] for c in COLLECTIVES)
    out["total_wire_bytes"] = sum(out[c] * WIRE_FACTOR[c]
                                  for c in COLLECTIVES)
    for c in COLLECTIVES:
        out[f"n_{c}"] = counts[c]
    return out


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   wire_bytes_per_device: float) -> Dict[str, float]:
    """The three roofline times (seconds) for one step on one card."""
    t_compute = flops_per_device / PEAK_FLOPS_BF16
    t_memory = bytes_per_device / HBM_BW
    t_collective = wire_bytes_per_device / NET_BW
    terms = {"t_compute": t_compute, "t_memory": t_memory,
             "t_collective": t_collective}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom
    total = max(terms["t_compute"], terms["t_memory"], terms["t_collective"])
    terms["bound_seconds"] = total
    terms["compute_fraction"] = t_compute / total if total else 0.0
    return terms
