"""LM serving launcher of the PyTorch port: batched greedy decoding with
the bucketed engine.

    # On the card (every decode attention through the flash-decode kernel):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2p5_3b \
        --requests 16 --prompt-lens 16,520 --max-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_small \
        --prompt-lens 16,64

    # On the CPU, with the kernel's plain version, at a smoke size:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_130m \
        --smoke --device cpu

    # Sharded decode on a (data, model) mesh, one rank a device: four
    # gloo ranks on the CPU, or one card a rank (NCCL).
    OMP_NUM_THREADS=1 PYTHONPATH=src torchrun --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch qwen2p5_3b --smoke \
        --device cpu --mesh 2x2

The flags and the last line (the stats JSON) are those of
``repro.launch.serve``, plus ``--device`` (default ``cuda``; without a card
it fails, and nothing falls back to the CPU).  Every family is served; audio
and vlm models attend to zero frontend features of the config's
``encoder_seq`` / ``vision_seq`` rows, as the reference's launcher gives
them.  ``--mesh DxM`` other than ``1x1`` needs a world of D x M ranks
(``torchrun``, or a process group this process already joined; ``1x1``
outside one is the one-device path): the parameters are placed by the
rules in mode ``tp`` and the decode runs under the decode-kind policy
with its KV cache's sequence on ``model``, as the reference's launcher
does; every rank serves the same requests and rank 0 prints.  The
weights are a random init from ``--seed`` (the same on every rank);
nothing is downloaded.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from repro_torch import configs
from repro_torch.core import env as env_lib
from repro_torch.launch import train
from repro_torch.models import common, lm
from repro_torch.serving import Engine, ServeConfig, synthetic_requests


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen1p5_0p5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prompt-lens", default="8,16")
    ap.add_argument("--mesh", default="1x1",
                    help="data x model, e.g. 2x2 (a world of D x M ranks)")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs; cuda fails without a card")
    args = ap.parse_args(argv)
    try:
        cfg = (configs.get_smoke(args.arch) if args.smoke
               else configs.get(args.arch))
        train.parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    if args.f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    return args, cfg


def run(argv=None) -> dict:
    """Serve as the flags say; prints the header and stats lines (rank 0
    alone when sharded) and returns the stats with the requests
    (``reqs``, their outputs filled)."""
    args, cfg = parse_args(argv)
    dev = env_lib.resolve_device(args.device)
    owned = not train._dist_initialized()
    try:
        mesh = train.build_mesh(args.mesh, args.device)
    except ValueError as e:             # no world of D x M ranks
        print(f"serve: error: {e}", file=sys.stderr)
        raise SystemExit(2)
    try:
        return _serve(args, cfg, dev, mesh)
    finally:
        if mesh is not None and owned:
            import torch.distributed as dist
            dist.destroy_process_group()


def _serve(args, cfg, dev, mesh) -> dict:
    lead = True
    pol = common.NO_SHARDING
    if mesh is not None:
        import torch.distributed as dist
        lead = dist.get_rank() == 0
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    say = print if lead else (lambda *a, **k: None)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    if mesh is not None:
        # Every rank drew the same whole tensors; each keeps its shards.
        from repro_torch.distributed import sharding
        sharding.distribute_model(params, mesh, "tp")
        pol = sharding.make_policy(mesh, batch=args.max_batch, kind="decode")
    cross_feats = None
    if lm.cross_sites(cfg):
        S = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_seq
        cross_feats = torch.zeros((1, S, cfg.d_model), device=dev,
                                  dtype=common.dtype(cfg.compute_dtype))
    engine = Engine(cfg, params, ServeConfig(max_len=args.max_len,
                                             max_batch=args.max_batch),
                    pol=pol, cross_feats=cross_feats)
    plens = tuple(int(x) for x in args.prompt_lens.split(","))
    reqs = synthetic_requests(args.requests, cfg.vocab_size,
                              prompt_lens=plens, max_new=args.max_new,
                              seed=args.seed)
    say(f"arch={cfg.name} family={cfg.family} params={n_params/1e6:.1f}M "
        f"requests={args.requests} mesh={args.mesh} device={dev}",
        flush=True)
    stats = engine.serve(reqs)
    assert all(r.done and len(r.output) > 0 for r in reqs)
    say(json.dumps(stats), flush=True)
    return {**stats, "reqs": reqs}


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
