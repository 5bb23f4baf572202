"""The port's LM serving engine and CLI, on the CPU.

The port's ``Engine`` and the JAX package's serve the same
``synthetic_requests`` (same numpy draws) with the same weights
(``params_from_jax`` of ``test_torch_lm.reference_tree``) in float32, and
must emit the same tokens; audio and vlm engines attend to the same
seeded random frontend features.  The rest are the port's counterparts of
the reference's engine tests (tests/test_serving.py).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.serving import Engine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.serving.engine import synthetic_requests as jsynthetic
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.serving import (Engine, Request, ServeConfig,
                                 synthetic_requests)
from test_torch_lm import reference_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _engine(arch="qwen1p5_0p5b", **scfg):
    cfg = _f32(configs.get_smoke(arch))
    model = lm.init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, Engine(cfg, model, ServeConfig(**{"max_len": 64,
                                                  "max_batch": 4, **scfg}))


# The six families of the reference's engine test (tests/test_serving.py),
# and qwen2.5-3b (GQA, QKV bias).
@pytest.mark.parametrize("arch", ["qwen1p5_0p5b", "qwen2p5_3b",
                                  "mamba2_130m", "zamba2_1p2b",
                                  "whisper_small", "llama3p2_vision_90b",
                                  "phi3p5_moe_42b"])
def test_engine_tokens_equal_reference_engine(arch):
    jcfg = _f32(jconfigs.get_smoke(arch))
    cfg = _f32(configs.get_smoke(arch))
    tree = reference_tree(jcfg)
    jparams = jax.tree.map(jax.numpy.asarray, tree)
    model = lm.params_from_jax(tree, cfg)
    feats = None
    if lm.cross_sites(cfg):
        S = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_seq
        feats = np.random.default_rng(8).standard_normal(
            (1, S, cfg.d_model)).astype(np.float32)
    scfg = dict(max_len=24, max_batch=3)
    jreqs = jsynthetic(7, cfg.vocab_size, prompt_lens=(4, 9), max_new=6,
                       seed=3)
    reqs = synthetic_requests(7, cfg.vocab_size, prompt_lens=(4, 9),
                              max_new=6, seed=3)
    assert [r.prompt for r in reqs] == [r.prompt for r in jreqs]
    jstats = JEngine(jcfg, jparams, JServeConfig(**scfg),
                     cross_feats=None if feats is None
                     else jax.numpy.asarray(feats)).serve(jreqs)
    eng = Engine(cfg, model, ServeConfig(**scfg),
                 cross_feats=None if feats is None
                 else torch.from_numpy(feats))
    stats = eng.serve(reqs)
    for a, b in zip(reqs, jreqs):
        assert a.output == b.output, (a.uid, a.output, b.output)
        assert a.done and len(a.output) == 6
    assert set(stats) == set(jstats)
    assert {k: stats[k] for k in ("requests", "tokens", "buckets")} == {
        k: jstats[k] for k in ("requests", "tokens", "buckets")}
    # Per batch: one step per prompt token, then max_new decode steps.
    # Buckets of 4 and 9 tokens, batches of at most 3 requests.
    lens = [len(r.prompt) for r in reqs]
    batches = {n: -(-lens.count(n) // 3) for n in set(lens)}
    assert eng.decode_steps == sum(b * (n + 6) for n, b in batches.items())


def test_cross_families_need_frontend_features():
    cfg = _f32(configs.get_smoke("whisper_small"))
    model = lm.init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, model, ServeConfig(max_len=16, max_batch=2))
    with pytest.raises(ValueError, match="cross_feats"):
        eng.serve(synthetic_requests(1, cfg.vocab_size, prompt_lens=(3,),
                                     max_new=2))
    with pytest.raises(ValueError, match="cross K/V"):
        lm.decode_step(model, cfg, lm.init_cache(cfg, 1, 4),
                       torch.tensor([1]))


def test_generates_requested_tokens():
    cfg, eng = _engine("qwen3_32b")
    reqs = synthetic_requests(5, cfg.vocab_size, prompt_lens=(4, 7),
                              max_new=6)
    stats = eng.serve(reqs)
    assert stats["requests"] == 5 and stats["buckets"] == 2
    assert all(r.done and len(r.output) == 6 for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.output)


def test_batched_matches_single_request():
    """Lockstep batching must not change any request's greedy output."""
    cfg, eng = _engine()
    reqs = synthetic_requests(4, cfg.vocab_size, prompt_lens=(5,), max_new=5)
    solo = [Request(uid=r.uid, prompt=list(r.prompt),
                    max_new_tokens=r.max_new_tokens) for r in reqs]
    eng.serve(reqs)
    _, eng2 = _engine(max_batch=1)
    eng2.serve(solo)
    for a, b in zip(reqs, solo):
        assert a.output == b.output, (a.uid, a.output, b.output)


def test_stop_token_retires_request():
    cfg, eng = _engine()
    probe = synthetic_requests(1, cfg.vocab_size, prompt_lens=(4,),
                               max_new=3, seed=7)
    eng.serve(probe)
    stop = probe[0].output[0]
    _, eng2 = _engine(stop_token=stop)
    reqs = synthetic_requests(1, cfg.vocab_size, prompt_lens=(4,),
                              max_new=8, seed=7)
    eng2.serve(reqs)
    assert reqs[0].output == [stop]


def test_engine_respects_cache_capacity():
    cfg, eng = _engine(max_len=12)
    reqs = [Request(uid=0, prompt=[1] * 8, max_new_tokens=100)]
    eng.serve(reqs)
    # 8 prompt + generation must stay within max_len - 1.
    assert len(reqs[0].output) == 12 - 8 - 1
    with pytest.raises(ValueError, match="max_len"):
        eng.serve([Request(uid=1, prompt=[1] * 13, max_new_tokens=1)])


def _cli(*args):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], env=env,
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_serve_cli_on_cpu_prints_stats():
    proc = _cli("--arch", "qwen2p5_3b", "--smoke", "--device", "cpu",
                "--requests", "5", "--max-new", "4", "--prompt-lens", "3,6")
    assert proc.returncode == 0, proc.stderr[-2000:]
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(stats) == {"requests", "tokens", "wall_s", "tok_per_s",
                          "buckets"}
    assert stats["requests"] == 5 and stats["tokens"] == 20


@pytest.mark.parametrize("arch", ["mamba2_130m", "whisper_small"])
def test_serve_cli_serves_other_families_on_cpu(arch):
    """The SSM family (no attention cache) and the audio family (cross
    K/V from the launcher's zero features) through the CLI."""
    proc = _cli("--arch", arch, "--smoke", "--device", "cpu",
                "--requests", "3", "--max-new", "3", "--prompt-lens", "2,5")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"family={configs.get(arch).family}" in proc.stdout
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["requests"] == 3 and stats["tokens"] == 9


@pytest.mark.parametrize("args,msg", [
    pytest.param(("--mesh", "2x2"), "needs a torchrun-style world of 4",
                 id="args0-not ported yet"),
    pytest.param(("--arch", "no_such_arch"), "unknown architecture",
                 id="args1-not ported yet"),
])
def test_serve_cli_rejects_what_is_not_ported(args, msg):
    """``--mesh 2x2`` outside a world of four ranks is refused (sharded
    serving runs under ``torchrun``); so is an unknown --arch."""
    proc = _cli("--smoke", "--device", "cpu", *args)
    assert proc.returncode == 2
    assert msg in proc.stderr


def test_serve_cli_without_a_card_does_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda serves on it")
    proc = _cli("--arch", "mamba2_130m", "--smoke")      # --device cuda
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "tok_per_s" not in proc.stdout
