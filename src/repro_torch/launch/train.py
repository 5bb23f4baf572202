"""Training launcher of the PyTorch port: LM training with checkpoints.

    # On the card (bfloat16 compute, float32 master weights):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1p5_0p5b \
        --steps 40 --batch 8 --seq 1024 --ckpt-dir /tmp/ckpt

    # On the CPU at a smoke size:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1p5_0p5b \
        --smoke --device cpu --f32 --steps 24 --batch 2 --seq 32

    # Sharded over a (data, model) mesh of 2 x 2 ranks (gloo on the CPU,
    # NCCL on cards, one card a rank):
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen1p5_0p5b --smoke --device cpu --f32 --mesh 2x2

The flags, the log lines, the summary line (the last: ``final_loss``,
``first_loss``, ``steps``, ``steps_run``) and the exit rule are those of
``repro.launch.train``, plus ``--device`` (default ``cuda``; without a
card it fails, and nothing falls back to the CPU):

  * checkpoint / restart -- atomic manifest + npy checkpoints of (params,
    optimizer state) every ``--ckpt-every`` steps, written in the
    background; ``--resume`` restores the latest and continues with the
    same batches (the data is a pure function of the step).
  * gradient accumulation -- ``--micro`` splits the global batch into
    microbatches with float32 accumulators (``lm.train_step_accum``).
  * the optimizer -- Adam, weight decay 0.01, global-norm clipping at 1,
    a cosine schedule with ``--warmup`` steps of linear warm-up.
  * mesh sharding -- ``--mesh DxM`` runs under a ``torchrun``-style
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` / ``MASTER_PORT``) of exactly D * M ranks (NCCL on
    ``cuda``, one card a rank by ``LOCAL_RANK``; gloo on ``cpu``), builds
    a (data, model) ``DeviceMesh`` and applies the production rules in
    mode ``tp`` (``distributed/sharding.py``).  Rank 0 prints the log and
    the summary; checkpoints hold whole tensors (gathered, rank 0
    writes), so ``--resume`` restores onto any mesh (elastic restore).

The model is a random init from an explicit ``torch.Generator`` (seed 0);
nothing is downloaded.  Audio and vlm models train on zero frontend
features (``encoder_seq`` / ``vision_seq`` rows), as the serve launchers
give them; the reference's train launcher gives none, and fails there.
``--mesh 1x1`` without a process group is the one-device path; a mesh of
another size without a world of that size raises ``ValueError``.  The
exit code is 0 when the mean loss of the last 10 steps is below that of
the first 10, or when fewer than 20 steps ran (a short resume window).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import env as env_lib
from repro_torch.models import common, lm
from repro_torch.training import checkpoint, data, optim


def parse_mesh(spec: str):
    """'DxM' -> (D, M)."""
    try:
        d, m = (int(x) for x in spec.split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: expected DxM, e.g. 2x2")
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {spec!r}: sizes must be positive")
    return d, m


def build_mesh(spec: str, device: str):
    """None for '1x1' outside a process-group launch (the one-device
    path); else the (data, model) mesh over a world of exactly D * M
    ranks: the process group already initialised in this process, or a
    ``torchrun``-style one, which this call joins (NCCL on ``cuda``, the
    rank's card by ``LOCAL_RANK``; gloo on ``cpu``)."""
    d, m = parse_mesh(spec)
    world = (str(_world_size()) if _dist_initialized()
             else os.environ.get("WORLD_SIZE"))
    if world is None:
        if d * m == 1:
            return None
        raise ValueError(f"--mesh {spec} needs a torchrun-style world of "
                         f"{d * m} ranks (RANK, WORLD_SIZE, LOCAL_RANK, "
                         "MASTER_ADDR, MASTER_PORT); none is set")
    if int(world) != d * m:
        raise ValueError(f"--mesh {spec} needs {d * m} ranks, the world "
                         f"has {world}")
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    dev = env_lib.resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return mesh_lib.make_debug_mesh(d, m, device_type=dev.type)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1p5_0p5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro", type=int, default=1,
                    help="gradient-accumulation microbatches")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--mesh", default="1x1",
                    help="data x model, e.g. 2x2 (under torchrun)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "memmap"])
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--f32", action="store_true",
                    help="compute in float32 (CPU-friendly)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains; cuda fails without a "
                    "card")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """Train as the flags say; prints the log and summary lines and
    returns the summary with every step's loss (``losses``) and wall
    seconds (``step_s``, each ending in the loss's read-back)."""
    args = parse_args(argv)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    if args.f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    dev = env_lib.resolve_device(args.device)
    owned = not _dist_initialized()
    mesh = build_mesh(args.mesh, args.device)
    try:
        return _train(args, cfg, dev, mesh)
    finally:
        if mesh is not None and owned:
            import torch.distributed as dist
            dist.destroy_process_group()


def _dist_initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size()


def _train(args, cfg, dev, mesh) -> dict:
    pol = lm.NO_SHARDING
    lead = True
    if mesh is not None:
        import torch.distributed as dist
        from repro_torch.distributed import sharding
        lead = dist.get_rank() == 0
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    say = print if lead else (lambda *a, **k: None)

    opt = optim.Adam(
        lr=optim.cosine_schedule(args.lr, args.warmup, args.steps),
        weight_decay=0.01, clip_norm=1.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = lm.init_params(cfg, gen, device=dev, dtype=torch.float32)
    opt_state = opt.init(dict(model.named_parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    say(f"arch={cfg.name} family={cfg.family} params={n_params/1e6:.1f}M "
        f"mesh={args.mesh} batch={args.batch}x{args.seq} "
        f"micro={args.micro} device={dev}", flush=True)

    ds = data.make_dataset(data.DataConfig(
        seq_len=args.seq, global_batch=args.batch,
        vocab_size=cfg.vocab_size, source=args.data, path=args.data_path))

    start_step = 0
    if args.resume and args.ckpt_dir:
        try:
            (state, opt_state), start_step, _ = checkpoint.restore(
                args.ckpt_dir, (model.state_dict(), opt_state))
            model.load_state_dict(state)
            say(f"resumed from step {start_step}", flush=True)
        except FileNotFoundError:
            say("no checkpoint found; starting fresh", flush=True)

    if mesh is not None:
        # Every rank drew (or restored) the same whole tensors; each keeps
        # its shards.
        sharding.distribute_model(model, mesh, "tp")
        opt_state = sharding.distribute_opt_state(opt_state, model)
        pol = sharding.make_policy(mesh, batch=args.batch, kind="train",
                                   mode="tp")

    def state():
        """The checkpoint's tree: whole tensors (gathered when sharded)."""
        if mesh is None:
            return model.state_dict(), opt_state
        return (sharding.full_state(model.state_dict()),
                type(opt_state)(opt_state.step.full_tensor(),
                                sharding.full_state(opt_state.mu),
                                sharding.full_state(opt_state.nu)))

    stub = {}
    if lm.cross_sites(cfg):
        S = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_seq
        stub["frames" if cfg.family == "audio" else "patches"] = torch.zeros(
            (args.batch, S, cfg.d_model), device=dev,
            dtype=common.dtype(cfg.compute_dtype))

    losses, step_s, t0 = [], [], time.time()
    saver, last_saved = None, -1
    for step in range(start_step, args.steps):
        ts = time.perf_counter()
        batch = {**data.device_batch(ds.batch(step), dev), **stub}
        if mesh is not None:
            batch = sharding.place_batch(batch, mesh, mode="tp")
        model, opt_state, loss = lm.train_step_accum(
            model, opt_state, batch, cfg, opt, n_micro=args.micro, pol=pol)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - ts)
        if (step + 1) % args.log_every == 0:
            dt = time.time() - t0
            tok_s = args.log_every * args.batch * args.seq / dt
            say(f"step {step+1:5d}  loss "
                f"{np.mean(losses[-args.log_every:]):.4f}"
                f"  {tok_s:,.0f} tok/s", flush=True)
            t0 = time.time()
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            if saver is not None:
                saver.join()
            tree = state()
            saver = (checkpoint.save(
                args.ckpt_dir, step + 1, tree,
                meta={"loss": float(loss)}, blocking=False) if lead
                else None)
            last_saved = step + 1
    if saver is not None:
        saver.join()  # never race the async writer with the final save
    if args.ckpt_dir and last_saved != args.steps and losses:
        tree = state()
        if lead:
            checkpoint.save(args.ckpt_dir, args.steps, tree,
                            meta={"loss": float(losses[-1])})
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()              # the checkpoint is on disk for all
    summary = {"final_loss": float(np.mean(losses[-10:])),
               "first_loss": float(np.mean(losses[:10])),
               "steps": args.steps, "steps_run": len(losses)}
    say(json.dumps(summary), flush=True)
    return {**summary, "losses": losses, "step_s": step_s}


def main(argv=None) -> int:
    summary = run(argv)
    # Loss must improve -- but a short resume window (< 20 fresh steps)
    # cannot tell first from final; completion counts as success then.
    if summary["steps_run"] < 20:
        return 0
    return 0 if summary["final_loss"] < summary["first_loss"] else 1


if __name__ == "__main__":
    sys.exit(main())
