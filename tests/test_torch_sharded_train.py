"""Sharded LM training of the port on gloo CPU ranks against the JAX
package's unsharded train step.

One world of four ranks runs everything of this file (a module-scoped
fixture): this very file is the ranks' program (its ``__main__``), which
imports torch and the port only; the reference numbers are computed
once, here, with JAX, and the ranks get the same numbers as numpy
arrays.  On a (2, 2) ("data", "model") mesh, for one smoke config of each
family, the ranks run one ``lm.train_step`` under ``tp``, ``fsdp`` and
``dp`` (parameters and moments DTensors placed by the rules, the batch by
``batch_sharding``, the activations by ``make_policy``), the dense config
also with a clip that binds and through ``train_step_accum`` with two
microbatches; they check that every local shard is the block the spec
gives their mesh coordinates; and they record each mode's collectives
(``CommDebugMode``) and every redistribution of a parameter, with ``tp``
also on a (1, 2) submesh of two of the ranks.

Tolerances are the reference's own for its sharded modes
(``tests/test_sharding_modes.py``): loss 1e-4, parameters 5e-4 after one
Adam step at lr 1e-3.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen2p5_3b", "phi3p5_moe_42b", "mamba2_130m", "zamba2_1p2b",
         "whisper_small", "llama3p2_vision_90b")
MODES = ("tp", "fsdp", "dp")
DENSE = "qwen2p5_3b"
B, T, LR, CLIP = 8, 16, 1e-3, 0.01


def _cfg(arch):
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke(arch),
                               param_dtype="float32", compute_dtype="float32")


def _batch(cfg, seed=7):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family in ("audio", "vlm"):
        S = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_seq
        key = "frames" if cfg.family == "audio" else "patches"
        out[key] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    return out


# ---------------------------------------------------------------------------
# The ranks' program.
# ---------------------------------------------------------------------------
def _block(full, spec, coord, names, sizes):
    """The block of ``full`` that the JAX device at mesh coordinates
    ``coord`` holds under ``spec`` (a tuple of axes splits its dim major
    to minor)."""
    idx = []
    for d, ax in enumerate(tuple(spec) + (None,) * (full.ndim - len(spec))):
        if ax is None:
            idx.append(slice(None))
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        i, n = 0, 1
        for a in axes:
            k = names.index(a)
            i, n = i * sizes[k] + coord[k], n * sizes[k]
        step = full.shape[d] // n
        idx.append(slice(i * step, (i + 1) * step))
    return full[tuple(idx)]


def _rank_main(rank, world, store, npz, out):
    import torch.distributed as dist
    import torch.distributed.tensor._api as dapi
    import torch.distributed.tensor._dispatch as ddisp
    import torch.distributed.tensor._redistribute as dred
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import lm
    from repro_torch.training import optim

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    z = dict(np.load(npz))
    res = {}
    mesh = mesh_lib.make_debug_mesh(2, 2, device_type="cpu")

    # Every redistribution of a parameter's own storage: (mesh dims
    # gathered, as "data" / "model").
    gathered, param_ptrs = [], set()
    real = dred.redistribute_local_tensor

    def spy(local, cur, tgt, **kw):
        if local.untyped_storage().data_ptr() in param_ptrs:
            names = cur.mesh.mesh_dim_names
            gathered.append(tuple(
                names[i] for i, (a, b) in enumerate(zip(cur.placements,
                                                        tgt.placements))
                if isinstance(a, Shard) and not isinstance(b, Shard)))
        return real(local, cur, tgt, **kw)

    for mod in (dapi, ddisp, dred):
        mod.redistribute_local_tensor = spy

    def model_of(arch, m, mode):
        cfg = _cfg(arch)
        model = lm.LM(cfg, dtype=torch.float32)
        model.load_state_dict({k[len(arch) + 3:]: torch.from_numpy(v)
                               for k, v in z.items()
                               if k.startswith(f"{arch}/p/")})
        sharding.distribute_model(model, m, mode)
        return cfg, model

    def batch_of(arch, m, mode):
        b = {k[len(arch) + 3:]: torch.from_numpy(v) for k, v in z.items()
             if k.startswith(f"{arch}/b/")}
        b = {k: (v.long() if v.dtype == torch.int32 else v)
             for k, v in b.items()}
        return sharding.place_batch(b, m, mode=mode)

    def step(arch, mode, m=mesh, clip=None, n_micro=1, tag=None):
        cfg, model = model_of(arch, m, mode)
        opt = optim.Adam(lr=LR, clip_norm=clip)
        state = sharding.distribute_opt_state(
            opt.init({k: p.detach().full_tensor()
                      for k, p in model.named_parameters()}), model)
        pol = sharding.make_policy(m, batch=B, kind="train", mode=mode)
        batch = batch_of(arch, m, mode)
        param_ptrs.clear()
        param_ptrs.update(p.to_local().untyped_storage().data_ptr()
                          for p in model.parameters())
        gathered.clear()
        tag = tag or f"{arch}/{mode}"
        # Collectives are counted in the dense runs only (the mode costs a
        # dispatch a operation).
        comm = CommDebugMode() if tag.startswith(DENSE) else None
        with comm or contextlib.nullcontext():
            _, state, loss = lm.train_step_accum(model, state, batch, cfg,
                                                 opt, n_micro=n_micro,
                                                 pol=pol)
        res[f"{tag}/loss"] = loss.numpy()
        if comm is not None:
            counts = {str(k).split(".")[-1]: v
                      for k, v in comm.get_comm_counts().items()}
            res[f"{tag}/comm"] = np.array(json.dumps(counts))
        res[f"{tag}/gathered"] = np.array(json.dumps(sorted(set(
            a for g in gathered for a in g))))
        for k, p in model.named_parameters():
            res[f"{tag}/p/{k}"] = p.detach().full_tensor().numpy()
        res[f"{tag}/step"] = state.step.full_tensor().numpy()
        return model, state

    try:
        for arch in ARCHS:
            for mode in MODES:
                model, state = step(arch, mode)
                if arch == DENSE and mode in ("tp", "fsdp"):
                    # Each local shard, of params and moments, is the block
                    # of its mesh coordinates.
                    names = mesh.mesh_dim_names
                    bad = 0
                    for k, p in model.named_parameters():
                        spec = sharding.model_spec(mesh, model, k, mode)
                        want = _block(p.full_tensor(), spec,
                                      mesh.get_coordinate(), names,
                                      tuple(mesh.shape))
                        bad += not torch.equal(p.to_local(), want)
                        bad += not torch.equal(
                            state.mu[k].to_local(),
                            _block(state.mu[k].full_tensor(), spec,
                                   mesh.get_coordinate(), names,
                                   tuple(mesh.shape)))
                    n = torch.tensor([bad])
                    dist.all_reduce(n)
                    res[f"shards/{mode}"] = n.numpy()
        # The unclipped gradient's norm (one device), which the clip binds.
        cfg, model = model_of(DENSE, mesh, "dp")
        plain = lm.LM(cfg, dtype=torch.float32)
        plain.load_state_dict({k: p.detach().full_tensor()
                               for k, p in model.named_parameters()})
        b = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
             for k, v in batch_of(DENSE, mesh, "dp").items()}
        _, g = lm._loss_and_grads(plain, lm._trainable(plain), cfg, b,
                                  None, True)
        res["clip/norm"] = optim.global_norm(g).numpy()
        for mode in MODES:
            step(DENSE, mode, clip=CLIP, tag=f"clip/{mode}")
            step(DENSE, mode, n_micro=2, tag=f"accum/{mode}")
        dist.barrier()
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()
    print("OK")


# ---------------------------------------------------------------------------
# The tests.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's unsharded steps (JAX) and the four ranks' outputs."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro.training import optim as joptim
    from repro_torch.models import lm
    from test_torch_lm import reference_tree

    tmp = tmp_path_factory.mktemp("sharded")
    inputs, trees, ref = {}, {}, {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                                   param_dtype="float32",
                                   compute_dtype="float32")
        tree = trees[arch] = (jcfg, reference_tree(jcfg), _batch(cfg))
        model = lm.LM(cfg, device="meta")
        for name, _ in model.named_parameters():
            path, idx = lm.jax_name(name)
            val = tree[1]
            for key in path:
                val = val[key]
            inputs[f"{arch}/p/{name}"] = np.asarray(val)[idx]
        for k, v in tree[2].items():
            inputs[f"{arch}/b/{k}"] = v
    npz = tmp / "inputs.npz"
    np.savez(npz, **inputs)
    world = 4
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    out = tmp / "out.npz"
    # Files, not pipes: the ranks write while this process runs JAX.
    logs = [(open(tmp / f"rank{r}.out", "w"), open(tmp / f"rank{r}.err", "w"))
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(tmp / "store"), str(npz), str(out)], env=env,
        stdout=logs[r][0], stderr=logs[r][1])
        for r in range(world)]
    try:
        # The reference's steps while the ranks run.
        for arch, (jcfg, tree, batch) in trees.items():
            cases = [(arch, None, 1)]
            if arch == DENSE:
                cases += [("clip", CLIP, 1), ("accum", None, 2)]
            for tag, clip, n_micro in cases:
                opt = joptim.Adam(lr=LR, clip_norm=clip)
                params = jax.tree.map(jnp.asarray, tree)
                p, _, loss = jax.jit(lambda p, s, b: jlm.train_step_accum(
                    p, s, b, jcfg, opt, n_micro=n_micro))(
                        params, opt.init(params), batch)
                ref[f"{tag}/loss"] = float(loss)
                ref[f"{tag}/params"] = jax.tree.map(np.asarray, p)
        for p in procs:
            p.wait(timeout=400)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        for f in logs[r]:
            f.close()
        so = (tmp / f"rank{r}.out").read_text()
        se = (tmp / f"rank{r}.err").read_text()
        assert p.returncode == 0 and "OK" in so, se[-4000:]
    return ref, dict(np.load(out))


def _check_step(ref, got, ref_tag, tag, arch):
    from repro_torch.models import lm
    assert abs(float(got[f"{tag}/loss"]) - ref[f"{ref_tag}/loss"]) < 1e-4
    assert int(got[f"{tag}/step"]) == 1
    model = lm.LM(_cfg(arch), device="meta")
    for name, _ in model.named_parameters():
        path, idx = lm.jax_name(name)
        val = ref[f"{ref_tag}/params"]
        for key in path:
            val = val[key]
        np.testing.assert_allclose(got[f"{tag}/p/{name}"],
                                   np.asarray(val)[idx], atol=5e-4, rtol=0,
                                   err_msg=f"{tag} {name}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_unsharded_reference(runs, arch, mode):
    ref, got = runs
    _check_step(ref, got, arch, f"{arch}/{mode}", arch)


@pytest.mark.parametrize("mode", MODES)
def test_binding_clip_takes_the_whole_gradients_norm(runs, mode):
    """clip_norm 0.01 against a gradient norm far above it: a per-shard
    norm would scale each shard by its own factor and miss."""
    ref, got = runs
    assert float(got["clip/norm"]) > 10 * CLIP
    _check_step(ref, got, "clip", f"clip/{mode}", DENSE)


@pytest.mark.parametrize("mode", MODES)
def test_train_step_accum_two_microbatches(runs, mode):
    ref, got = runs
    _check_step(ref, got, "accum", f"accum/{mode}", DENSE)


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
def test_local_shards_are_the_specs_blocks(runs, mode):
    """Params and first moments on all four ranks (fsdp: dims split over
    the merged ("data", "model") axes)."""
    _, got = runs
    assert int(got[f"shards/{mode}"][0]) == 0


def test_collectives_by_mode(runs):
    """Each mode's collectives on the (2, 2) mesh, by kind, and which mesh
    axes any parameter was gathered over: dp reduces gradients and
    gathers no parameter; fsdp gathers parameters over both axes and
    reduce-scatters gradients; tp gathers parameters over ``data`` only
    (the FSDP half of its rules) and never over ``model``: there the
    activations move to the weights (sequence all-gathers, all-to-alls
    between sequence and heads)."""
    _, got = runs
    tags = {m: f"{DENSE}/{m}" for m in MODES}
    comm = {m: json.loads(str(got[f"{t}/comm"])) for m, t in tags.items()}
    gath = {m: json.loads(str(got[f"{t}/gathered"]))
            for m, t in tags.items()}
    assert comm["dp"].get("all_reduce", 0) > 0
    assert gath["dp"] == []
    assert comm["fsdp"].get("all_gather_into_tensor", 0) > 0
    assert comm["fsdp"].get("reduce_scatter_tensor", 0) > 0
    assert gath["fsdp"] == ["data", "model"]
    assert gath["tp"] == ["data"]
    assert comm["tp"].get("all_gather_into_tensor", 0) > 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(REPO, "src"))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
