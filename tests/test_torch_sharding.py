"""The port's sharding rules against the JAX package's pure rule
functions, the input-shape grid, and ``remat="dots"``.

The rule functions of both packages read only a mesh's axis names and
sizes, so they take the same plain mesh-like object here (no device, no
process group).  Reference shapes come from ``jax.eval_shape`` of
``repro.models.lm.init_params`` and the port's from an ``LM`` built on
``device="meta"``, at full width: nothing is allocated.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.distributed import sharding as jsharding
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.models import lm

MODES = ("tp", "tp_serve", "fsdp", "dp")


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


MESHES = [FakeMesh((1, 1), ("data", "model")),
          FakeMesh((2, 2), ("data", "model")),
          FakeMesh((4, 2), ("data", "model")),
          FakeMesh((16, 16), ("data", "model")),
          FakeMesh((2, 16, 16), ("pod", "data", "model"))]


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """{reference path: shape} of the full-width config's params, and the
    port's meta model."""
    cfg = jconfigs.get(arch)
    tree = jax.eval_shape(functools.partial(jlm.init_params, cfg=cfg),
                          jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    ref = {jsharding.norm_path(kp): tuple(leaf.shape) for kp, leaf in flat}
    return ref, lm.LM(configs.get(arch), device="meta")


@pytest.mark.parametrize("mode", MODES)
def test_param_spec_matches_reference_at_full_width(mode):
    """Every parameter leaf of every config, on five meshes: the port's
    ``param_spec`` on the reference's paths and shapes gives the
    reference's spec, and each port parameter's spec
    (``model_spec``: the spec of its reference leaf without the stack
    dims) is that spec's trailing part."""
    n = n_stack = 0
    for arch in configs.ARCH_IDS:
        ref, model = _shapes(arch)
        for mesh in MESHES:
            want = {path: tuple(jsharding.param_spec(mesh, path, shape, mode))
                    for path, shape in ref.items()}
            for path, shape in ref.items():
                got = sharding.param_spec(mesh, path, shape, mode)
                assert got == want[path], (arch, path, mesh.shape, mode)
            for name, p in model.named_parameters():
                path = sharding.param_path(name)
                shape = sharding.reference_shape(model, name)
                assert shape == ref[path], (arch, name)
                spec = want[path] + (None,) * (len(shape) - len(want[path]))
                n_lead = len(shape) - p.dim()
                got = sharding.model_spec(mesh, model, name, mode)
                if any(s is not None for s in spec[:n_lead]):
                    # fsdp's largest dim is a stack dim: the same rule on
                    # the per-layer shape.
                    assert mode == "fsdp", (arch, name)
                    alone = tuple(jsharding._fsdp_spec(mesh, tuple(p.shape)))
                    assert got == alone + (None,) * (p.dim() - len(alone))
                    n_stack += 1
                else:
                    assert got == spec[n_lead:], (arch, name, mesh.shape)
                n += 1
    assert n > 10_000
    assert (n_stack > 0) == (mode == "fsdp")


def test_fsdp_splits_merged_axes_in_the_mesh_order():
    """A dim split over a tuple of axes becomes one Shard(d) on each of
    those mesh dims; a tuple out of the mesh's order is refused (DTensor
    would split it in mesh order, not the tuple's)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES[4]
    spec = sharding.param_spec(mesh, "blocks/mlp/w_up", (24, 1024, 4096),
                               "fsdp")
    assert spec == (None, None, ("pod", "data", "model"))
    assert sharding.placements(mesh, spec, 3) == (Shard(2),) * 3
    assert sharding.placements(mesh, ("data", None), 2) == (
        Replicate(), Shard(0), Replicate())
    # The batch: B over every axis in fsdp, over (pod, data) in tp.
    assert sharding.batch_sharding(mesh, 512, mode="fsdp") == (Shard(0),) * 3
    assert sharding.batch_sharding(mesh, 64, mode="tp") == (
        Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="order"):
        sharding.placements(mesh, (("model", "data"),), 1)


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
def test_batch_axis_and_batch_sharding_match_reference(mode):
    for mesh in MESHES:
        for batch in (1, 2, 3, 4, 8, 12, 32, 64, 128, 256, 512, 1024):
            for inc in (False, True):
                assert sharding._batch_axis(mesh, batch, include_model=inc) \
                    == jsharding._batch_axis(mesh, batch, include_model=inc)
            dp = jsharding._batch_axis(mesh, batch,
                                       include_model=mode in ("fsdp", "dp"))
            dp = dp[0] if dp and len(dp) == 1 else dp
            assert sharding.batch_spec(mesh, batch, mode=mode) == (dp, None)
    # The reference's NamedSharding on the one mesh this process has.
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    for batch in (1, 8):
        assert tuple(jsharding.batch_sharding(jmesh, batch, mode=mode).spec) \
            == sharding.batch_spec(MESHES[0], batch, mode=mode)


def test_input_shapes_match_reference():
    assert [dataclasses.asdict(s) for s in configs.SHAPES] == \
        [dataclasses.asdict(s) for s in jbase.SHAPES]
    for s in jbase.SHAPES:
        assert dataclasses.asdict(configs.get_shape(s.name)) == \
            dataclasses.asdict(s)
    with pytest.raises(KeyError):
        configs.get_shape("train_8k")


def test_decode_kind_and_cache_shardings_wait_for_sharded_serving():
    mesh = MESHES[1]
    with pytest.raises(ValueError, match="sharded serving"):
        sharding.make_policy(mesh, batch=8, kind="decode")
    with pytest.raises(ValueError, match="sharded serving"):
        sharding.cache_shardings(mesh, None, batch=8)
    with pytest.raises(ValueError, match="mode"):
        sharding.param_spec(mesh, "blocks/attn/wq", (8, 8), "zero")


# ---------------------------------------------------------------------------
# remat="dots".
# ---------------------------------------------------------------------------
class _Count(TorchDispatchMode):
    """Counts the products run while it is active."""

    OPS = {"aten.mm.default": "mm", "aten.addmm.default": "mm",
           "aten.bmm.default": "bmm"}

    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kind = self.OPS.get(str(func))
        if kind:
            self.n[kind] += 1
        return func(*args, **(kwargs or {}))


def _loss_grads_counts(arch, remat):
    cfg = dataclasses.replace(configs.get_smoke(arch), param_dtype="float32",
                              compute_dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    model = lm.init_params(cfg, gen, dtype=torch.float32)
    named = lm._trainable(model)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)))
    aux = None
    if lm.cross_sites(cfg):
        S = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_seq
        aux = {"frames" if cfg.family == "audio" else "patches":
               torch.from_numpy(rng.standard_normal(
                   (2, S, cfg.d_model)).astype(np.float32))}
    loss = lm.lm_loss(model, cfg, toks[:, :-1], toks[:, 1:], aux,
                      remat=remat)
    count = _Count()
    with count:                     # the backward, with its recomputation
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
    return loss, grads, count.n


@pytest.mark.parametrize("arch", ["qwen2p5_3b", "phi3p5_moe_42b",
                                  "mamba2_130m"])
def test_remat_dots_agrees_with_full_and_none(arch):
    """Loss and gradients are bit-equal under dots, full and none
    (recomputation is deterministic on the CPU)."""
    out = {r: _loss_grads_counts(arch, r) for r in ("full", "dots", "none")}
    for r in ("dots", "none"):
        assert torch.equal(out[r][0], out["full"][0]), r
        for a, b in zip(out[r][1], out["full"][1]):
            assert torch.equal(a, b), r


@pytest.mark.parametrize("arch", ["qwen2p5_3b", "phi3p5_moe_42b"])
def test_remat_dots_keeps_the_projections_only(arch):
    """The products the backward re-runs: under dots no weight projection
    is recomputed (as many products as with no remat at all, fewer than
    under full), while attention's batched products are (as many as under
    full, more than with none), and so are the MoE experts' products,
    which carry a batch dim (E) in the reference: with experts, dots
    re-runs more plain products than none does."""
    n = {r: _loss_grads_counts(arch, r)[2] for r in ("full", "dots", "none")}
    assert n["dots"]["bmm"] == n["full"]["bmm"] > n["none"]["bmm"]
    assert n["full"]["mm"] > n["dots"]["mm"]
    if arch == "phi3p5_moe_42b":
        assert n["dots"]["mm"] > n["none"]["mm"]
    else:
        assert n["dots"]["mm"] == n["none"]["mm"]


def test_unknown_remat_raises():
    cfg = dataclasses.replace(configs.get_smoke("qwen1p5_0p5b"),
                              param_dtype="float32", compute_dtype="float32")
    model = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=torch.float32)
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="remat"):
        lm.lm_loss(model, cfg, toks, toks, remat="offload")
