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

The flags and the last line (the stats JSON) are those of
``repro.launch.serve``, plus ``--device`` (default ``cuda``; without a card
it fails, and nothing falls back to the CPU).  Every family is served; audio
and vlm models attend to zero frontend features of the config's
``encoder_seq`` / ``vision_seq`` rows, as the reference's launcher gives
them.  ``--mesh`` (sharded decode) is not ported yet and is rejected: it
comes with sharded serving (``cache_shardings``, the decode-kind policy),
the slice after sharded training.  The weights are a random init from
``--seed``; nothing is downloaded.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from repro_torch import configs
from repro_torch.core import env as env_lib
from repro_torch.models import common, lm
from repro_torch.serving import Engine, ServeConfig, synthetic_requests


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen1p5_0p5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prompt-lens", default="8,16")
    ap.add_argument("--mesh", default=None,
                    help="not ported yet: sharded decode comes with "
                    "sharded serving, the slice after sharded training")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs; cuda fails without a card")
    args = ap.parse_args(argv)

    if args.mesh is not None:
        ap.error("--mesh is not ported yet in the PyTorch port: sharded "
                 "decode comes with sharded serving (cache_shardings, the "
                 "decode-kind policy), the slice after sharded training; "
                 "drop --mesh to serve on one device")
    try:
        cfg = (configs.get_smoke(args.arch) if args.smoke
               else configs.get(args.arch))
    except ValueError as e:
        ap.error(str(e))
    if args.f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    dev = env_lib.resolve_device(args.device)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    cross_feats = None
    if lm.cross_sites(cfg):
        S = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_seq
        cross_feats = torch.zeros((1, S, cfg.d_model), device=dev,
                                  dtype=common.dtype(cfg.compute_dtype))
    engine = Engine(cfg, params, ServeConfig(max_len=args.max_len,
                                             max_batch=args.max_batch),
                    cross_feats=cross_feats)
    plens = tuple(int(x) for x in args.prompt_lens.split(","))
    reqs = synthetic_requests(args.requests, cfg.vocab_size,
                              prompt_lens=plens, max_new=args.max_new,
                              seed=args.seed)
    print(f"arch={cfg.name} family={cfg.family} params={n_params/1e6:.1f}M "
          f"requests={args.requests} device={dev}", flush=True)
    stats = engine.serve(reqs)
    assert all(r.done and len(r.output) > 0 for r in reqs)
    print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
