"""Sharded LM serving of the port on gloo CPU ranks against the JAX
package's unsharded decode.

One world of four ranks runs everything of this file (a module-scoped
fixture): this very file is the ranks' program (its ``__main__``), which
imports torch and the port only; the reference numbers are computed once,
here, with JAX, while the ranks run, and the ranks get the same weights
as numpy arrays.  For the smoke config of each family, in float32, under
``tp`` and ``tp_serve``, the ranks decode two batches greedily (prompts
of 3 and 9 tokens, then 6 new tokens, in a cache of ``TMAX`` = 16 rows)
through ``lm.decode_step`` with the decode-kind policy, parameters placed
by ``distribute_model`` and the cache by ``place_cache``: on the (2, 2)
("data", "model") mesh of all four ranks, and on a (1, 2) submesh of each
pair of ranks.  The cache's sequence is split on ``model``, so the first
eight steps run with the second rank's shard empty and later ones attend
across the shard boundary.  The ranks also check that every local shard
of the cache and the parameters is the block its spec gives their mesh
coordinates, and serve through ``repro_torch.launch.serve.run`` with
``--mesh 2x2`` in their world; ``torchrun`` runs the CLI as well.

Checks: the tokens of the reference's unsharded decode and its logits
within 1e-4 at every step (the reference's own sharded serving cannot run
under this JAX: ``make_policy`` fails on its Explicit mesh axes).
"""
import contextlib
import dataclasses
import io
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
MODES = ("tp", "tp_serve")
MESHES = ("2x2", "1x2")
B, TMAX, PROMPTS, NEW = 4, 16, (3, 9), 6
CLI = ["--arch", "qwen2p5_3b", "--smoke", "--device", "cpu", "--f32",
       "--requests", "4", "--max-new", "3", "--prompt-lens", "3,5",
       "--max-len", "16", "--mesh", "2x2"]
TOL = dict(atol=1e-4, rtol=0)


def _cfg(arch):
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke(arch),
                               param_dtype="float32", compute_dtype="float32")


def _inputs(cfg, seed=11):
    """The prompts of both batches and the frontend features."""
    rng = np.random.default_rng(seed)
    out = {f"prompt{p}": rng.integers(0, cfg.vocab_size, (B, p)).astype(
        np.int64) for p in PROMPTS}
    if cfg.family in ("audio", "vlm"):
        # An odd patch count, as llama-3.2-vision's 1,601: no mesh splits
        # the vlm's cross K/V on their sequence; whisper's 32 frames split.
        S = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_seq - 1
        out["feats"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    return out


# ---------------------------------------------------------------------------
# The ranks' program.
# ---------------------------------------------------------------------------
def _block(full, spec, coord, names, sizes):
    """The block of ``full`` that the JAX device at mesh coordinates
    ``coord`` holds under ``spec``."""
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


def _decode(model, cfg, prompt, feats=None, mesh=None, pol=None):
    """The prompt (b, p) teacher-forced, then NEW greedy tokens, through
    ``lm.decode_step``, sharded when ``mesh`` is given: (logits (steps,
    b, V), tokens (NEW, b), the last cache)."""
    from repro_torch.distributed import sharding
    from repro_torch.models import lm

    b, p = prompt.shape
    cache = lm.init_cache(cfg, b, TMAX)
    kw = {}
    if mesh is not None:
        cache = sharding.place_cache(cache, mesh, batch=b)
        kw["pol"] = pol
    if lm.cross_sites(cfg):
        k, v = lm.precompute_cross_kv(model, cfg, feats, **kw)
        cache = cache._replace(cross_k=k, cross_v=v)
    logits, toks, tok = [], [], prompt[:, 0]
    for t in range(p + NEW - 1):
        lg, cache = lm.decode_step(model, cfg, cache, tok, **kw)
        if mesh is not None:
            lg = lg.full_tensor()
        logits.append(lg.numpy())
        tok = prompt[:, t + 1] if t + 1 < p else lg.argmax(-1)
        if t + 1 >= p:
            toks.append(tok.numpy())
    return np.stack(logits), np.stack(toks), cache


def _greedy(model, cfg, mesh, pol, z, arch):
    """Both batches, sharded: {prompt length: (logits, tokens)} and the
    last cache."""
    out = {}
    feats = (torch.from_numpy(z[f"{arch}/i/feats"])
             if f"{arch}/i/feats" in z else None)
    for p in PROMPTS:
        prompt = torch.from_numpy(z[f"{arch}/i/prompt{p}"])
        lg, tk, cache = _decode(model, cfg, prompt, feats, mesh, pol)
        out[p] = (lg, tk)
    return out, cache


def _bad_shards(model, cache, mesh, mode, batch):
    """How many local shards of the parameters and the cache differ from
    the blocks their specs give this rank's mesh coordinates."""
    import torch.utils._pytree as pytree
    from repro_torch.distributed import sharding

    names, sizes = mesh.mesh_dim_names, tuple(mesh.shape)
    coord = mesh.get_coordinate()
    bad = 0
    for k, p in model.named_parameters():
        spec = sharding.model_spec(mesh, model, k, mode)
        bad += not torch.equal(p.to_local(), _block(
            p.full_tensor(), spec, coord, names, sizes))
    specs = pytree.tree_leaves(
        sharding.cache_shardings(mesh, cache, batch=batch),
        is_leaf=lambda x: isinstance(x, sharding.Sharding))
    for t, sh in zip(pytree.tree_leaves(cache), specs):
        if isinstance(t, torch.Tensor):
            bad += not torch.equal(t.to_local(), _block(
                t.full_tensor(), sh.spec, coord, names, sizes))
    return bad


def _rank_main(rank, world, store, npz, out):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import sharding
    from repro_torch.launch import serve
    from repro_torch.models import lm

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    z = dict(np.load(npz))
    res = {}
    meshes = {"2x2": init_device_mesh("cpu", (2, 2),
                                      mesh_dim_names=("data", "model")),
              # Two (1, 2) submeshes: ranks 0-1 and 2-3 each decode alone.
              "1x2": init_device_mesh(
                  "cpu", (2, 1, 2), mesh_dim_names=("pair", "data", "model"))[
                      "data", "model"]}
    try:
        bad = 0
        for arch in ARCHS:
            cfg = _cfg(arch)
            for mname, mesh in meshes.items():
                for mode in MODES:
                    model = lm.LM(cfg, dtype=torch.float32)
                    model.load_state_dict({
                        k[len(arch) + 3:]: torch.from_numpy(v)
                        for k, v in z.items() if k.startswith(f"{arch}/p/")})
                    sharding.distribute_model(model, mesh, mode)
                    pol = sharding.make_policy(mesh, batch=B, kind="decode",
                                               mode=mode)
                    got, cache = _greedy(model, cfg, mesh, pol, z, arch)
                    for p, (lg, tk) in got.items():
                        res[f"{arch}/{mname}/{mode}/{p}/logits"] = lg
                        res[f"{arch}/{mname}/{mode}/{p}/tokens"] = tk
                    bad += _bad_shards(model, cache, mesh, mode, B)
        n = torch.tensor([bad])
        dist.all_reduce(n)
        res["bad_shards"] = n.numpy()
        # MoE decode with fewer tokens than the ranks that split them: one
        # request on the (2, 2) mesh (its token on one of the two token
        # shards), against the unsharded port on the same weights.
        arch = "phi3p5_moe_42b"
        cfg = _cfg(arch)
        weights = {k[len(arch) + 3:]: torch.from_numpy(v)
                   for k, v in z.items() if k.startswith(f"{arch}/p/")}
        plain = lm.LM(cfg, dtype=torch.float32)
        plain.load_state_dict(weights)
        prompt = torch.from_numpy(z[f"{arch}/i/prompt3"][:1])
        want = _decode(plain, cfg, prompt)
        sharding.distribute_model(plain, meshes["2x2"], "tp")
        got = _decode(plain, cfg, prompt, mesh=meshes["2x2"],
                      pol=sharding.make_policy(meshes["2x2"], batch=1,
                                               kind="decode"))
        res["moe_one_token/diff"] = np.array(
            np.abs(got[0] - want[0]).max())
        res["moe_one_token/same"] = np.array(
            np.array_equal(got[1], want[1]))
        # The launcher in this world: rank 0 prints.
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            stats = serve.run(CLI)
        res["cli/stdout"] = np.array(buf.getvalue())
        res["cli/outputs"] = np.array([r.output for r in stats["reqs"]])
        dist.barrier()
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()
    print("OK")


# ---------------------------------------------------------------------------
# The tests.
# ---------------------------------------------------------------------------
def _reference(arch, tree, inputs):
    """The reference's unsharded greedy decode of both batches."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import lm as jlm

    jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                               param_dtype="float32", compute_dtype="float32")
    params = jax.tree.map(jnp.asarray, tree)
    step = jax.jit(jlm.decode_step, static_argnums=1)
    out = {}
    for p in PROMPTS:
        prompt = inputs[f"prompt{p}"]
        cache = jlm.init_cache(jcfg, B, TMAX)
        if "feats" in inputs:
            k, v = jlm.precompute_cross_kv(params, jcfg,
                                           jnp.asarray(inputs["feats"]))
            cache = cache._replace(cross_k=k, cross_v=v)
        logits, toks, tok = [], [], prompt[:, 0]
        for t in range(p + NEW - 1):
            lg, cache = step(params, jcfg, cache, jnp.asarray(tok, jnp.int32))
            lg = np.asarray(lg)
            logits.append(lg)
            tok = prompt[:, t + 1] if t + 1 < p else lg.argmax(-1)
            if t + 1 >= p:
                toks.append(tok)
        out[p] = (np.stack(logits), np.stack(toks))
    return out


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's decodes (JAX), the unsharded engine's CLI run, the
    torchrun CLI run and the four ranks' outputs."""
    from repro import configs as jconfigs
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from test_torch_lm import reference_tree

    tmp = tmp_path_factory.mktemp("sharded_serve")
    inputs, trees = {}, {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                                   param_dtype="float32",
                                   compute_dtype="float32")
        tree = trees[arch] = reference_tree(jcfg)
        model = lm.LM(cfg, device="meta")
        for name, _ in model.named_parameters():
            path, idx = lm.jax_name(name)
            val = tree
            for key in path:
                val = val[key]
            inputs[f"{arch}/p/{name}"] = np.asarray(val)[idx]
        for k, v in _inputs(cfg).items():
            inputs[f"{arch}/i/{k}"] = v
    npz = tmp / "inputs.npz"
    np.savez(npz, **inputs)
    world = 4
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    out = tmp / "out.npz"
    logs = [(open(tmp / f"rank{r}.out", "w"), open(tmp / f"rank{r}.err", "w"))
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(tmp / "store"), str(npz), str(out)], env=env,
        stdout=logs[r][0], stderr=logs[r][1])
        for r in range(world)]
    try:
        ref = {arch: _reference(arch, trees[arch], _inputs(_cfg(arch)))
               for arch in ARCHS}
        # The unsharded launcher run (the ranks' own weights: the same
        # seed), in this process.
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            stats = serve.run(CLI[:-2])
        plain = (buf.getvalue(), [r.output for r in stats["reqs"]])
        env.pop("WORLD_SIZE", None)
        launched = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", "4", "--master-addr", "127.0.0.1",
             "--master-port", str(_free_port()),
             "-m", "repro_torch.launch.serve", *CLI], env=env, cwd=REPO,
            capture_output=True, text=True, timeout=300)
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
    return ref, dict(np.load(out)), plain, launched


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_unsharded_reference(runs, arch, mode, mesh):
    """Tokens equal, logits within 1e-4 at every step of both batches,
    steps with an empty shard included."""
    ref, got, _, _ = runs
    for p in PROMPTS:
        want_logits, want_tokens = ref[arch][p]
        tag = f"{arch}/{mesh}/{mode}/{p}"
        np.testing.assert_array_equal(got[f"{tag}/tokens"], want_tokens,
                                      err_msg=tag)
        np.testing.assert_allclose(got[f"{tag}/logits"], want_logits,
                                   err_msg=tag, **TOL)


def test_moe_decode_with_fewer_tokens_than_token_shards(runs):
    """One request of the MoE model on the (2, 2) mesh: the experts split
    on ``model``, the one token on one of the two ``data`` shards; the
    unsharded port's tokens, logits within 1e-4."""
    _, got, _, _ = runs
    assert bool(got["moe_one_token/same"])
    assert float(got["moe_one_token/diff"]) <= 1e-4


def test_local_shards_are_the_specs_blocks(runs):
    """Every parameter and cache tensor on all four ranks, on both meshes
    and in both modes, after decoding."""
    _, got, _, _ = runs
    assert int(got["bad_shards"][0]) == 0


def test_serve_mesh_2x2_prints_the_unsharded_runs_stats(runs):
    """``serve --mesh 2x2`` in the ranks' world and under ``torchrun``:
    rank 0 prints the header and the unsharded run's stats keys last, all
    requests are done, and the outputs are the unsharded engine's."""
    _, got, (plain_out, plain_outputs), launched = runs
    assert launched.returncode == 0, launched.stderr[-2000:]
    want = json.loads(plain_out.strip().splitlines()[-1])
    assert got["cli/outputs"].tolist() == plain_outputs
    for text in (str(got["cli/stdout"]), launched.stdout):
        lines = text.strip().splitlines()
        assert lines[0].startswith("arch=qwen2p5_smoke") and \
            "mesh=2x2" in lines[0], text
        stats = json.loads(lines[-1])
        assert set(stats) == set(want)
        assert stats["requests"] == 4 and stats["tokens"] == 12
        assert stats["buckets"] == want["buckets"]
    assert len(launched.stdout.strip().splitlines()) == 2   # rank 0 only


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(REPO, "src"))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
