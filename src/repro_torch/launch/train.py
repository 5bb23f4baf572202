"""Training launcher of the PyTorch port: LM training with checkpoints.

    # On the card (bfloat16 compute, float32 master weights):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1p5_0p5b \
        --steps 40 --batch 8 --seq 1024 --ckpt-dir /tmp/ckpt

    # On the CPU at a smoke size:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1p5_0p5b \
        --smoke --device cpu --f32 --steps 24 --batch 2 --seq 32

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

The model is a random init from an explicit ``torch.Generator`` (seed 0);
nothing is downloaded.  Audio and vlm models train on zero frontend
features (``encoder_seq`` / ``vision_seq`` rows), as the serve launchers
give them; the reference's train launcher gives none, and fails there.
``--mesh`` other than 1x1 (sharded training) is not ported yet and raises
``ValueError``.  The exit code is 0 when the mean loss of the last 10
steps is below that of the first 10, or when fewer than 20 steps ran (a
short resume window).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import env as env_lib
from repro_torch.models import common, lm
from repro_torch.training import checkpoint, data, optim


def check_mesh(spec: str):
    """'1x1' is one device; any other mesh raises ``ValueError``."""
    d, m = (int(x) for x in spec.split("x"))
    if d * m != 1:
        raise ValueError(
            f"--mesh {spec}: sharded training is not ported to the PyTorch "
            "port yet; it comes with the sharding slice "
            "(distributed/sharding.py, pipeline.py, launch/mesh.py). Use "
            "--mesh 1x1")


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
                    help="data x model; only 1x1 is ported")
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
    check_mesh(args.mesh)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    if args.f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    dev = env_lib.resolve_device(args.device)

    opt = optim.Adam(
        lr=optim.cosine_schedule(args.lr, args.warmup, args.steps),
        weight_decay=0.01, clip_norm=1.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = lm.init_params(cfg, gen, device=dev, dtype=torch.float32)
    opt_state = opt.init(dict(model.named_parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} family={cfg.family} params={n_params/1e6:.1f}M "
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
            print(f"resumed from step {start_step}", flush=True)
        except FileNotFoundError:
            print("no checkpoint found; starting fresh", flush=True)

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
        model, opt_state, loss = lm.train_step_accum(
            model, opt_state, batch, cfg, opt, n_micro=args.micro)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - ts)
        if (step + 1) % args.log_every == 0:
            dt = time.time() - t0
            tok_s = args.log_every * args.batch * args.seq / dt
            print(f"step {step+1:5d}  loss "
                  f"{np.mean(losses[-args.log_every:]):.4f}"
                  f"  {tok_s:,.0f} tok/s", flush=True)
            t0 = time.time()
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            if saver is not None:
                saver.join()
            saver = checkpoint.save(
                args.ckpt_dir, step + 1, (model.state_dict(), opt_state),
                meta={"loss": float(loss)}, blocking=False)
            last_saved = step + 1
    if saver is not None:
        saver.join()  # never race the async writer with the final save
    if args.ckpt_dir and last_saved != args.steps and losses:
        checkpoint.save(args.ckpt_dir, args.steps,
                        (model.state_dict(), opt_state),
                        meta={"loss": float(losses[-1])})
    summary = {"final_loss": float(np.mean(losses[-10:])),
               "first_loss": float(np.mean(losses[:10])),
               "steps": args.steps, "steps_run": len(losses)}
    print(json.dumps(summary), flush=True)
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
