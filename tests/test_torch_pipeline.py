"""The port's GPipe pipeline and its train launcher's ``--mesh`` on gloo
CPU ranks.

The pipeline case is the reference's own (``tests/test_pipeline.py``):
``qwen3_32b``'s smoke config at four layers on a (2, 2) ("data",
"model") mesh, M = 1, 2 and 4 microbatches, against the reference's
unsharded ``lm.train_step`` from the same numbers (JAX, here, once), at
its tolerances: loss 2e-4, parameters 5e-4.  One world of four ranks
runs all three (this file is the ranks' program, torch only; each stage
takes the reference tree through ``pipeline.params_from_jax``).

The launcher trains the smoke model under ``torchrun`` on four gloo
ranks (``--mesh 2x2``, mode tp) for 30 steps, checkpointing every six;
the step-18 checkpoint then resumes on a 2x1 world, whose losses must
continue the uninterrupted run's (the counterpart of
``examples/elastic_restart.py``).
"""
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3_32b"
B, T, LR, MICRO, CLIP = 8, 32, 1e-3, (1, 2, 4), 0.01


def _cfg(jax_side=False):
    if jax_side:
        from repro import configs
    else:
        from repro_torch import configs
    return dataclasses.replace(configs.get_smoke(ARCH), param_dtype="float32",
                               compute_dtype="float32", num_layers=4)


def _rank_main(rank, world, store, npz, out):
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import pipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.training import optim

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        z = dict(np.load(npz))
        tree = {}
        for key, val in z.items():
            if key.startswith("p/"):
                node = tree
                *path, leaf = key[2:].split("/")
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = val
        batch = {k: torch.from_numpy(z[k]).long()
                 for k in ("tokens", "labels")}
        cfg = _cfg()
        mesh = mesh_lib.make_debug_mesh(2, 2, device_type="cpu")
        res = {}
        for M in (*MICRO, "clip"):
            opt = optim.Adam(lr=LR, clip_norm=CLIP if M == "clip" else None)
            params = pipeline.params_from_jax(tree, cfg, mesh)
            state = pipeline.opt_init(params, opt)
            step = pipeline.make_pp_train_step(
                cfg, opt, mesh, n_micro=2 if M == "clip" else M)
            params, state, loss = step(params, state, batch)
            res[f"{M}/loss"] = loss.numpy()
            res[f"{M}/overhead"] = np.array(step.pipeline_overhead)
            res[f"{M}/first"] = np.array(params.first)
            for k, p in params.named_parameters():
                res[f"{M}/p/{k}"] = p.detach().numpy()
            res[f"{M}/steps"] = np.array([int(o.step) for o in state])
        np.savez(f"{out}.{rank}.npz", **res)
    finally:
        dist.destroy_process_group()
    print("OK")


@pytest.fixture(scope="module")
def pp(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.distributed import sharding as jsharding
    from repro.models import lm as jlm
    from repro.training import optim as joptim
    from test_torch_lm import reference_tree

    tmp = tmp_path_factory.mktemp("pp")
    jcfg = _cfg(jax_side=True)
    tree = reference_tree(jcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    inputs = {f"p/{jsharding.norm_path(kp)}": v for kp, v in flat}
    np.savez(tmp / "in.npz", **inputs, **batch)
    world = 4
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    # Files, not pipes: the ranks write while this process runs JAX.
    logs = [(open(tmp / f"rank{r}.out", "w"), open(tmp / f"rank{r}.err", "w"))
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(tmp / "store"), str(tmp / "in.npz"), str(tmp / "out")],
        env=env, stdout=logs[r][0], stderr=logs[r][1])
        for r in range(world)]
    try:
        # The reference's steps while the ranks run.
        params = jax.tree.map(jnp.asarray, tree)
        ref = {}
        for tag, clip in (("plain", None), ("clip", CLIP)):
            opt = joptim.Adam(lr=LR, clip_norm=clip)
            p1, _, l1 = jax.jit(lambda p, s, b: jlm.train_step(
                p, s, b, jcfg, opt))(params, opt.init(params), batch)
            ref[tag] = (float(l1), jax.tree.map(np.asarray, p1))
        g = jax.grad(lambda p: jlm.lm_loss(p, jcfg, toks, toks))(params)
        ref["norm"] = float(joptim.global_norm(g))
        for p in procs:
            p.wait(timeout=300)
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
    ranks = [dict(np.load(tmp / f"out.{r}.npz")) for r in range(world)]
    return ref, ranks


def _ref_leaf(tree, name, first):
    """The reference's value of a stage's parameter ``name``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        val = tree["blocks"]
        for key in parts[2:]:
            val = val[key]
        return val[first + int(parts[1])]
    val = tree
    for key in parts:
        val = val[key]
    return val


@pytest.mark.parametrize("M", (*MICRO, "clip"))
def test_pp_matches_reference(pp, M):
    """M = 1, 2, 4 with the reference test's Adam; "clip": M = 2 with a
    clip far below the gradient's norm against the reference's unsharded
    step with that clip (the whole gradient's norm: the reference's own
    pipeline clips each part and stage by its own)."""
    ref, ranks = pp
    l1, p1 = ref["clip" if M == "clip" else "plain"]
    if M == "clip":
        assert ref["norm"] > 10 * CLIP
    for r, got in enumerate(ranks):
        assert abs(float(got[f"{M}/loss"]) - l1) < 2e-4, (M, r)
        first = int(got[f"{M}/first"])
        assert first == (r % 2) * 2          # stage = model coordinate
        names = [k[len(f"{M}/p/"):] for k in got if k.startswith(f"{M}/p/")]
        assert sum(n.startswith("blocks.") for n in names) > 0
        for name in names:
            np.testing.assert_allclose(got[f"{M}/p/{name}"],
                                       _ref_leaf(p1, name, first),
                                       atol=5e-4, rtol=0,
                                       err_msg=f"M={M} rank {r} {name}")
        assert list(got[f"{M}/steps"]) == [1, 1]
        m = 2 if M == "clip" else M
        assert float(got[f"{M}/overhead"]) == (m + 2 - 1) / m


def test_pp_refuses_other_families_and_uneven_stages():
    from repro_torch.distributed import pipeline

    class OneRank:
        def size(self, i):
            return 3

        mesh_dim_names = ("data", "model")

        def get_local_rank(self, ax):
            return 0

    with pytest.raises(ValueError, match="dense"):
        pipeline._stage(dataclasses.replace(_cfg(), family="moe"), OneRank())
    with pytest.raises(ValueError, match="multiple"):
        pipeline._stage(_cfg(), OneRank())


def test_pp_shardings_put_the_stage_on_model():
    """The PP layout's specs: blocks' layers on ``model``, the embedding
    and the step counts replicated, moments as their parameters."""
    from repro_torch.distributed import pipeline
    from repro_torch.training import optim

    params = pipeline.PPModel(_cfg(), 0, 2, device="meta")
    opt = optim.Adam()
    psh, (ob, oe) = pipeline.pp_shardings(None, params,
                                          pipeline.opt_init(params, opt))
    assert psh["blocks.0.attn.wq"] == ("model",)
    assert psh["embed.tok"] == ()
    assert ob["step"] == () and ob["mu"]["blocks.1.mlp.w_up"] == ("model",)
    assert oe["nu"]["embed.norm_f"] == ()


# ---------------------------------------------------------------------------
# The launcher under torchrun.
# ---------------------------------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun(n, args, cwd):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(n), "--master-addr", "127.0.0.1", "--master-port",
         str(_free_port()), "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=400, env=env, cwd=cwd)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _losses(ckpt_dir):
    """Each checkpoint's step and logged loss."""
    out = {}
    for d in sorted(os.listdir(ckpt_dir)):
        if d.startswith("step_"):
            with open(os.path.join(ckpt_dir, d, "manifest.json")) as f:
                out[int(d[5:])] = json.load(f)["meta"]["loss"]
    return out


def test_mesh_2x2_trains_and_resumes_on_2x1(tmp_path):
    common = ["--arch", "qwen1p5_0p5b", "--smoke", "--device", "cpu",
              "--f32", "--steps", "30", "--batch", "8", "--seq", "16",
              "--log-every", "6", "--ckpt-every", "6"]
    full = tmp_path / "full"
    out = _torchrun(4, common + ["--mesh", "2x2", "--ckpt-dir", str(full)],
                    tmp_path)
    lines = out.strip().splitlines()
    assert lines[0].startswith("arch=qwen1p5_smoke") and "mesh=2x2" in lines[0]
    assert sum(ln.startswith("step ") for ln in lines) == 5   # rank 0 only
    summary = json.loads(lines[-1])
    assert summary["steps_run"] == 30
    assert summary["final_loss"] < summary["first_loss"]

    # Elastic restore: the step-18 checkpoint (whole tensors; the launcher
    # keeps the last three) on 2 x 1.
    resumed = tmp_path / "resumed"
    resumed.mkdir()
    shutil.copytree(full / "step_0000000018", resumed / "step_0000000018")
    out2 = _torchrun(2, common + ["--mesh", "2x1", "--resume",
                                  "--ckpt-dir", str(resumed)], tmp_path)
    assert "resumed from step 18" in out2
    assert json.loads(out2.strip().splitlines()[-1])["steps_run"] == 12
    a, b = _losses(full), _losses(resumed)
    assert sorted(b) == [18, 24, 30]
    for s in (24, 30):                 # examples/elastic_restart.py's bound
        assert abs(b[s] - a[s]) < 5e-3, (s, a[s], b[s])
    logged = lambda out: [ln.split("tok/s")[0].split()[:4]
                          for ln in out.splitlines()
                          if ln.startswith(("step    24", "step    30"))]
    assert logged(out2) == logged(out)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(REPO, "src"))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
