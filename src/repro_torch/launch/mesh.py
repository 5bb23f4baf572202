"""Device meshes of the LM's sharded training.

The counterpart of the JAX package's ``launch/mesh.py``, over
``torch.distributed.device_mesh.init_device_mesh``.  Defined as functions
(never module-level meshes), so importing this module touches no process
group: a mesh needs an initialised ``torch.distributed`` world of exactly
its size (one rank a device; ``launch/train.py`` sets it up from a
``torchrun``-style environment).
"""
from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh


def _device_type(device_type):
    if device_type is not None:
        return device_type
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16x16 = 256 devices a pod; 2x16x16 = 512 across two pods.

    Axes: ``data`` carries DP + FSDP, ``model`` carries TP / EP / SP, and
    ``pod`` (multi-pod only) carries pure data parallelism.  The device
    type follows the world's backend (NCCL: ``cuda``, gloo: ``cpu``)
    unless given.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_debug_mesh(n_data: int = 1, n_model: int = 1, device_type=None):
    """A (n_data, n_model) ("data", "model") mesh over the world's ranks."""
    return init_device_mesh(_device_type(device_type), (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def axis_names(mesh) -> tuple:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or the
    ``axis_names`` of any mesh-like object (the rule functions' tests)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def data_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)
