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


# ---------------------------------------------------------------------------
# The decode side: cache layouts, the decode-kind hooks, tree paths.
# ---------------------------------------------------------------------------
def _abstract(mesh):
    return jax.sharding.AbstractMesh(tuple(mesh.shape.values()),
                                     mesh.axis_names)


def _ref_cache(jcfg, batch, max_len):
    """The reference's decode cache as shapes, cross K/V included."""
    cache = jax.eval_shape(lambda: jlm.init_cache(jcfg, batch, max_len))
    n_cross = lm.cross_sites(jcfg)
    if n_cross:
        S = jcfg.encoder_seq if jcfg.family == "audio" else jcfg.vision_seq
        kv = jax.ShapeDtypeStruct(
            (n_cross, batch, S, jcfg.num_kv_heads, jcfg.hd()), np.float32)
        cache = cache._replace(cross_k=kv, cross_v=kv)
    return cache


def _port_cache(cfg, batch, max_len):
    cache = lm.init_cache(cfg, batch, max_len, device="meta")
    n_cross = lm.cross_sites(cfg)
    if n_cross:
        S = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_seq
        kv = torch.empty((n_cross, batch, S, cfg.num_kv_heads, cfg.hd()),
                         device="meta")
        cache = cache._replace(cross_k=kv, cross_v=kv)
    return cache


def _ref_mamba_leaf(path, cfg):
    """The reference's cache path of the port's ``mamba/<i>/<leaf>``."""
    _, i, leaf = path.split("/")
    if cfg.family == "ssm":
        return f"mamba/{leaf}"
    n_groups = cfg.num_layers // cfg.shared_attn_period
    grouped = int(i) < n_groups * cfg.shared_attn_period
    return f"mamba/{'groups' if grouped else 'tail'}/{leaf}"


def _pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def _flat_shardings(tree):
    return {sharding.norm_path(kp): sh for kp, sh in
            torch.utils._pytree.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, sharding.Sharding))[0]
            if sh is not None}


@pytest.mark.parametrize("batch,max_len", [(8, 1024), (1, 1000),
                                           (128, 4096)])
def test_cache_shardings_match_reference_at_full_width(batch, max_len):
    """Every leaf of every config's decode cache, on five meshes (the
    reference's on an ``AbstractMesh`` of the same shape): attention and
    cross K/V and ``pos`` as the reference's; each per-layer Mamba tensor
    the trailing part of its stacked reference leaf's spec."""
    n = 0
    for arch in configs.ARCH_IDS:
        jcfg, cfg = jconfigs.get(arch), configs.get(arch)
        jc = _ref_cache(jcfg, batch, max_len)
        shapes = {jsharding.norm_path(kp): leaf.shape for kp, leaf in
                  jax.tree_util.tree_flatten_with_path(jc)[0]}
        port = _port_cache(cfg, batch, max_len)
        port_shapes = {sharding.norm_path(kp): tuple(getattr(t, "shape", ()))
                       for kp, t in
                       torch.utils._pytree.tree_flatten_with_path(port)[0]
                       if t is not None}
        for mesh in MESHES:
            want = {jsharding.norm_path(kp): tuple(s.spec) for kp, s in
                    jax.tree_util.tree_flatten_with_path(
                        jsharding.cache_shardings(_abstract(mesh), jc,
                                                  batch=batch))[0]}
            got = _flat_shardings(sharding.cache_shardings(mesh, port,
                                                           batch=batch))
            assert set(got) == set(port_shapes)
            for path, sh in got.items():
                ref_path = (_ref_mamba_leaf(path, cfg)
                            if path.startswith("mamba/") else path)
                ref_ndim, ndim = len(shapes[ref_path]), len(port_shapes[path])
                assert port_shapes[path] == shapes[ref_path][ref_ndim - ndim:]
                spec = _pad(want[ref_path], ref_ndim)
                assert all(a is None for a in spec[:ref_ndim - ndim])
                assert _pad(sh.spec, ndim) == spec[ref_ndim - ndim:], (
                    arch, path, mesh.shape)
                assert sh.placements == sharding.placements(mesh, sh.spec,
                                                            ndim)
                n += 1
            mapped = {_ref_mamba_leaf(p, cfg) if p.startswith("mamba/")
                      else p for p in got}
            assert mapped == set(want), arch
    assert n > 300


class _Spy:
    """Records the specs the hooks constrain to (the port's redistribute,
    the reference's ``with_sharding_constraint``)."""

    def __init__(self, monkeypatch):
        self.port, self.ref = [], []
        monkeypatch.setattr(sharding, "_redistribute",
                            lambda x, mesh, spec: self.port.append(
                                _pad(sharding._canonical(spec), x.ndim))
                            or x)
        monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                            lambda x, s: self.ref.append(
                                _pad(tuple(s.spec), x.ndim)) or x)


def _hook_inputs(cfg, batch, max_len):
    """(hook, shape) of every decode-kind hook's site for ``cfg``."""
    hd, H, Kv = cfg.hd(), cfg.num_heads, cfg.num_kv_heads
    out = [("resid", (batch, 1, cfg.d_model)),
           ("heads", (batch, 1, H, hd)), ("kv_full", (batch, 1, Kv, hd)),
           ("ffn", (batch, 1, cfg.d_ff)),
           ("logits", (batch, 1, cfg.vocab_size)),
           ("cache", (batch, max_len, Kv, hd)),
           ("cache", (batch, 3, Kv, hd))]
    if cfg.family in ("ssm", "hybrid"):
        P = cfg.ssm_head_dim
        out.append(("ssm_x", (batch, 1, cfg.ssm_expand * cfg.d_model // P,
                               P)))
    if cfg.family == "moe":
        E = cfg.num_experts
        out += [("experts", (1, E, 4, cfg.d_model)),
                ("dispatch", (1, batch, E * 4)),
                ("experts_flat", (1, E * 4, cfg.d_ff))]
    return out


@pytest.mark.parametrize("mode", ["tp", "tp_serve"])
def test_decode_hooks_match_reference_at_full_width(mode, monkeypatch):
    """The decode-kind policy's hooks constrain every site to the
    reference's spec, for all ten configs on the five meshes: the
    residual not sequence-parallel, heads on ``model`` where they divide,
    ``kv_full`` no constraint, the cache's sequence on ``model``."""
    spy = _Spy(monkeypatch)
    n = 0
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch)
        for mesh in MESHES:
            for batch, max_len in ((8, 1024), (3, 100)):
                pol = sharding.make_policy(mesh, batch=batch, kind="decode",
                                           mode=mode)
                jpol = jsharding.make_policy(_abstract(mesh), batch=batch,
                                             kind="decode", mode=mode)
                for hook, shape in _hook_inputs(cfg, batch, max_len):
                    spy.port.clear()
                    spy.ref.clear()
                    getattr(pol, hook)(torch.empty(shape, device="meta"))
                    getattr(jpol, hook)(jax.ShapeDtypeStruct(shape,
                                                             np.float32))
                    assert spy.port == spy.ref, (arch, hook, shape,
                                                 mesh.shape)
                    n += bool(spy.ref)
    assert n > 500


def test_tree_shardings_and_norm_path_match_reference():
    """The reference's parameter tree of every config, at full width, on
    five meshes and in every mode: the port's ``tree_shardings`` (over a
    nested dict of meta tensors) gives each path the reference's spec;
    ``norm_path`` makes the reference's path strings of the port's key
    paths (dicts, NamedTuple fields, list indices); the modes'
    validation stays."""
    for arch in configs.ARCH_IDS:
        ref, _ = _shapes(arch)
        tree = {}
        for path, shape in ref.items():
            node = tree
            *keys, leaf = path.split("/")
            for k in keys:
                node = node.setdefault(k, {})
            node[leaf] = torch.empty(shape, device="meta")
        for mesh in MESHES[1:]:
            for mode in MODES:
                got = _flat_shardings(sharding.tree_shardings(mesh, tree,
                                                              mode))
                assert set(got) == set(ref)
                for path, sh in got.items():
                    want = tuple(jsharding.param_spec(mesh, path, ref[path],
                                                      mode))
                    assert sh.spec == want, (arch, path, mode)
    t = torch.zeros(1)
    cache = lm.Cache(t, t, [lm.ssm.MambaCache(t, t)], t, t, 3)
    paths = [sharding.norm_path(kp) for kp, _ in
             torch.utils._pytree.tree_flatten_with_path(cache)[0]]
    assert paths == ["attn_k", "attn_v", "mamba/0/conv", "mamba/0/ssm",
                     "cross_k", "cross_v", "pos"]
    jpaths = [jsharding.norm_path(kp) for kp, _ in
              jax.tree_util.tree_flatten_with_path(jlm.Cache(
                  0, 0, [jlm.ssm.MambaCache(0, 0)], 0, 0, 3))[0]]
    assert paths == jpaths
    with pytest.raises(ValueError, match="mode"):
        sharding.param_spec(MESHES[1], "blocks/attn/wq", (8, 8), "zero")
    with pytest.raises(ValueError, match="kind"):
        sharding.make_policy(MESHES[1], batch=8, kind="serve")


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
