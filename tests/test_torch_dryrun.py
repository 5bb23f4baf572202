"""The port's dry run (``repro_torch.launch.dryrun``) and what it reads --
``distributed/analytic.py``, ``distributed/comm_analysis.py``,
``sharding.sds_with_sharding``, flash decode's operators and the MoE
dispatch's fake-trace rows -- on the CPU, against the JAX package where it
has a counterpart.

The dry-run cells run in one subprocess (a module-scoped fixture): the
dry run makes fake process groups of 1 to 512 ranks, which must not meet
another test's world.  Smoke configs; long shapes only where the trace
is quick, since an eager trace runs every layer and every chunk.

No counterpart here: ``tests/test_hlo_analysis.py``'s HLO-text parsing
and ``tests/test_analytic.py::test_xla_undercounts_scans`` (the port has
no HLO; an eager step runs, and is counted, every trip of every loop).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("qwen1p5_0p5b", "phi3p5_moe_42b", "mamba2_130m", "zamba2_1p2b",
            "whisper_small", "llama3p2_vision_90b")


# ---------------------------------------------------------------------------
# analytic.py: the reference's closed form, number for number.
# ---------------------------------------------------------------------------
def _arch_shapes():
    from repro_torch import configs
    return [(a, s.name) for a in configs.ARCH_IDS for s in configs.SHAPES]


@pytest.mark.parametrize("arch,shape", _arch_shapes())
def test_analytic_equals_reference(arch, shape):
    from repro import configs as jconfigs
    from repro.distributed import analytic as janalytic

    from repro_torch import configs
    from repro_torch.distributed import analytic

    for group in (256, 64):
        for tf in (4.0, 3.3):
            want = janalytic.summarize(
                jconfigs.get(arch), jconfigs.get_shape(shape), 256,
                moe_group=group, train_factor=tf)
            got = analytic.summarize(configs.get(arch),
                                     configs.get_shape(shape), 256,
                                     moe_group=group, train_factor=tf)
            assert set(got) == set(want)
            for key in ("flops_breakdown", "bytes_breakdown"):
                assert set(got[key]) == set(want[key])
                for k, v in want[key].items():
                    assert got[key][k] == pytest.approx(v, rel=1e-12)
            for key in ("flops_total", "flops_per_device", "bytes_total",
                        "bytes_per_device"):
                assert got[key] == pytest.approx(want[key], rel=1e-12)


def test_analytic_scales_linearly_in_depth():
    """The reference's check, on the port."""
    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import analytic

    base = configs.get("qwen1p5_0p5b")
    deep = dataclasses.replace(base, num_layers=48)
    shape = InputShape("x", 1024, 4, "prefill")
    blocks = [analytic.flops_cell(c, shape)["total"]
              - analytic._unembed_flops(c, 4, 1) for c in (base, deep)]
    assert blocks[1] / blocks[0] == pytest.approx(2.0, rel=1e-6)


# FlopCounterMode over analytic on the reduced config of
# tests/test_analytic.py (2 layers, d 256, B 4, T 512): 0.9558 for
# qwen1.5-0.5b's train step, 1.0000 for its prefill and 0.9467 for
# starcoder2-3b's train step (this file's run on the CPU).  Analytic
# counts matmuls; FlopCounterMode counts the products it has formulas
# for (matmuls, einsums' bmm).
@pytest.mark.parametrize("arch,kind", [("qwen1p5_0p5b", "train"),
                                       ("qwen1p5_0p5b", "prefill"),
                                       ("starcoder2_3b", "train")])
def test_flop_counter_within_the_references_band(arch, kind):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import analytic
    from repro_torch.models import lm
    from repro_torch.training import optim

    cfg = dataclasses.replace(
        configs.get_smoke(arch), num_layers=2, d_model=256, num_heads=8,
        num_kv_heads=4, d_ff=1024, vocab_size=2048,
        param_dtype="float32", compute_dtype="float32")
    B, T = 4, 512
    gen = torch.Generator().manual_seed(0)
    model = lm.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen)
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            opt = optim.Adam(lr=1e-4)
            state = opt.init(dict(model.named_parameters()))
            lm.train_step(model, state, {"tokens": toks, "labels": toks},
                          cfg, opt)
        else:
            lm.prefill(model, cfg, toks)
    ours = analytic.flops_cell(cfg, InputShape("probe", T, B, kind))["total"]
    ratio = fc.get_total_flops() / ours
    assert 0.6 < ratio < 1.45, (fc.get_total_flops(), ours, ratio)


# ---------------------------------------------------------------------------
# comm_analysis.py: collectives by kind, the wire factor, the roofline.
# ---------------------------------------------------------------------------
def test_collective_stats_and_roofline_by_hand():
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed import comm_analysis as ca
    from repro_torch.launch import dryrun

    with dryrun.fake_world(4):
        group = dist.group.WORLD
        x = torch.ones(8, 16)                               # 512 bytes
        rec = ca.StepRecorder()
        with CommDebugMode() as cdm, rec:
            funcol.all_reduce(x, "sum", group).wait()
            funcol.reduce_scatter_tensor(torch.ones(64, 16), "sum", 0,
                                         group).wait()      # 1 KiB result
            funcol.all_gather_tensor(x, 0, group).wait()    # 2 KiB result
            dist.all_reduce(torch.ones(4, 4))               # 64 bytes
            dist.send(torch.ones(2, 8), dst=1)              # 64 bytes
        counts = cdm.get_comm_counts()
    stats = ca.collective_stats(rec.collectives)
    assert stats["all-reduce"] == 512 + 64
    assert stats["reduce-scatter"] == 4 * 1024              # the operand
    assert stats["all-gather"] == 2048
    assert stats["collective-permute"] == 64
    assert stats["all-to-all"] == 0
    assert stats["total_bytes"] == 576 + 4096 + 2048 + 64
    assert stats["total_wire_bytes"] == 2 * 576 + 4096 + 2048 + 64
    assert {k: stats[f"n_{k}"] for k in ca.COLLECTIVES} == {
        "all-reduce": 2, "all-gather": 1, "reduce-scatter": 1,
        "all-to-all": 0, "collective-permute": 1}
    # CommDebugMode counts the same calls (it does not count bytes).
    by_name = {str(op).split(".")[-1]: n for op, n in counts.items()}
    assert by_name.get("all_reduce", 0) + by_name.get("allreduce_", 0) == 2
    assert by_name["reduce_scatter_tensor"] == 1
    assert by_name["all_gather_into_tensor"] == 1
    # The roofline: each term by hand, the largest the bottleneck.
    terms = ca.roofline_terms(989e12, 3.35e12 * 2, 50e9 * 0.5)
    assert terms["t_compute"] == pytest.approx(1.0)
    assert terms["t_memory"] == pytest.approx(2.0)
    assert terms["t_collective"] == pytest.approx(0.5)
    assert terms["bottleneck"] == "t_memory"
    assert terms["bound_seconds"] == pytest.approx(2.0)
    assert terms["compute_fraction"] == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# input_specs and sds_with_sharding against the reference's shapes.
# ---------------------------------------------------------------------------
def _ref_cache_leaves(arch, B, T):
    """(path, shape, dtype) of the reference's decode inputs: its
    ``lm.init_cache`` leaves (``jax.eval_shape``) and the cross K/V its
    ``input_specs`` adds for audio and vlm."""
    import jax

    from repro import configs as jconfigs
    from repro.models import lm as jlm

    cfg = jconfigs.get_smoke(arch)
    cache = jax.eval_shape(lambda: jlm.init_cache(cfg, B, T))
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        path = "/".join(str(getattr(k, "name", getattr(k, "key", k)))
                        for k in kp)
        out[path] = (tuple(leaf.shape), str(leaf.dtype))
    if cfg.family in ("audio", "vlm"):
        S = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_seq
        sites = (cfg.num_layers if cfg.family == "audio"
                 else cfg.num_layers // cfg.cross_attn_period)
        for key in ("cross_k", "cross_v"):
            out[key] = ((sites, B, S, cfg.num_kv_heads, cfg.hd()),
                        cfg.compute_dtype)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_input_specs_match_reference_cache(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.launch import dryrun

    B, T = 32, 4096
    want = _ref_cache_leaves(arch, B, T)
    cfg = configs.get_smoke(arch)
    shape = dataclasses.replace(configs.get_shape("decode_32k"),
                                global_batch=B, seq_len=T)
    with dryrun.fake_world(256):
        mesh = dryrun.make_mesh("16x16", "cpu")
        with FakeTensorMode():
            specs = dryrun.input_specs(arch, "decode_32k", mesh, cfg=cfg,
                                       shape=shape)
    cache = specs["cache"]
    assert cache.pos == T - 1
    assert tuple(specs["token"].shape) == (B,)
    got = {}
    for key in ("attn_k", "attn_v", "cross_k", "cross_v"):
        t = getattr(cache, key)
        if t is not None:
            assert isinstance(t, DTensor)
            got[key] = (tuple(t.shape), str(t.dtype).split(".")[-1])
    # The reference stacks each Mamba leaf over its layers (hybrid: over
    # groups then layers, and a tail); the port keeps one a layer.
    for leaf in ("conv", "ssm"):
        mine = [getattr(mc, leaf) for mc in cache.mamba or ()]
        ref = [v for path, v in want.items()
               if path.startswith("mamba") and path.endswith(leaf)]
        layers = 0
        for shp, dt in ref:
            per = shp[-len(mine[0].shape):]
            layers += int(np.prod(shp[:len(shp) - len(per)]))
            assert per == tuple(mine[0].shape) and dt == "float32"
        assert len(mine) == layers
        assert all(t.shape == mine[0].shape and t.dtype == torch.float32
                   for t in mine)
    ref_attn = {k: v for k, v in want.items()
                if k in ("attn_k", "attn_v", "cross_k", "cross_v")}
    assert got == ref_attn


def test_sds_with_sharding_places_by_param_spec():
    import jax
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import DTensor

    from repro import configs as jconfigs
    from repro.models import lm as jlm
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun

    tree = jax.eval_shape(lambda: jlm.init_params(
        jax.random.PRNGKey(0), jconfigs.get("qwen2p5_3b")))
    shapes = pytree.tree_leaves(tree)
    with dryrun.fake_world(256):
        mesh = dryrun.make_mesh("16x16", "cpu")
        for mode in ("tp", "tp_serve", "fsdp", "dp"):
            fakes = pytree.tree_leaves(
                sharding.sds_with_sharding(mesh, tree, mode))
            want = pytree.tree_leaves(
                sharding.tree_shardings(mesh, tree, mode),
                is_leaf=lambda x: isinstance(x, sharding.Sharding))
            assert len(fakes) == len(want) == len(shapes)
            for leaf, t, sh in zip(shapes, fakes, want):
                assert isinstance(t, DTensor)
                assert tuple(t.shape) == tuple(leaf.shape)
                assert t.dtype == getattr(torch, str(leaf.dtype))
                assert tuple(t.placements) == tuple(sh.placements)
                local = list(leaf.shape)
                for i, pl in enumerate(sh.placements):
                    if pl.is_shard():
                        local[pl.dim] //= mesh.size(i)
                assert tuple(t.to_local().shape) == tuple(local)


# ---------------------------------------------------------------------------
# Flash decode's operators: fake kernels and FLOP formulas.
# ---------------------------------------------------------------------------
def test_flash_decode_fake_kernels_allocate_what_the_launches_do(
        monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import flash_decode as fd

    monkeypatch.setitem(fd._sm_counts, 0, 132)           # one H100
    B, Hq, Hkv, D = 8, 16, 2, 128
    cases = ((1024, torch.float32, fd.MAX_SPLITS), (80, torch.bfloat16, 32),
             (520, torch.bfloat16, 4))
    with FakeTensorMode():
        for T, dt, width in cases:
            q = torch.empty(B, Hq, D, dtype=dt, device="cuda")
            k = torch.empty(B, T, Hkv, D, dtype=dt, device="cuda")
            S = fd.plan_splits(B, Hkv, T, 132)[0]
            with FlopCounterMode(display=False) as fc:
                out, ws = torch.ops.repro_torch.flash_decode(q, k, k)
                whole = fd.flash_decode(q, k, k)
                parts = fd.flash_decode_partials(q, k, k, width)
                comb = fd.flash_decode_combine(parts)
            assert out.shape == whole.shape == (B, Hq, D)
            assert out.dtype == whole.dtype == torch.float32
            assert out.device.type == "cuda"
            assert ws.shape == ((B, Hq, S, D + 2) if S > 1 else (0,))
            Sp = fd.plan_splits(B, Hkv, T, 132, width)[0]
            assert parts.shape == (B, Hq, Sp, D + 2)
            assert parts.dtype == torch.float32
            assert comb.shape == (B, Hq, D) and comb.dtype == torch.float32
            counts = {str(k).split(".")[-1]: v for k, v in
                      fc.get_flop_counts()["Global"].items()}
            assert counts == {"flash_decode": 2 * 4 * B * Hq * T * D,
                              "flash_decode_partials": 4 * B * Hq * T * D,
                              "flash_decode_combine": 2 * B * Hq * Sp * D}
        empty = torch.empty(B, 0, Hkv, D, device="cuda")
        q = torch.empty(B, Hq, D, device="cuda")
        assert fd.flash_decode_partials(q, empty, empty, 4).shape == (
            B, Hq, 1, D + 2)


def test_flash_decode_wrappers_still_reject_cpu_tensors():
    from repro_torch.kernels import flash_decode as fd

    q, k = torch.zeros(1, 4, 16), torch.zeros(1, 5, 2, 16)
    for call in (lambda: fd.flash_decode(q, k, k),
                 lambda: fd.flash_decode_partials(q, k, k),
                 lambda: fd.flash_decode_combine(torch.zeros(1, 4, 2, 18))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()


# ---------------------------------------------------------------------------
# MoE: the eager dispatch is unchanged; a fake trace takes static rows.
# ---------------------------------------------------------------------------
def _expert_sums_before(cfg, x, router, w_gate, w_up, w_down, n_groups):
    """The dispatch loop as it was before fake traces had a path of their
    own (all experts, all tokens)."""
    import torch.nn.functional as F

    from repro_torch.models import common, moe

    B, T, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    r = moe.route(None, cfg, x, n_groups, router)
    ids = torch.where(r.keep, r.experts, E).reshape(-1)
    order = torch.argsort(ids, stable=True)
    counts = torch.bincount(ids, minlength=E + 1).tolist()
    rows = order // k
    wts = r.weight.reshape(-1)[order].to(x.dtype)[:, None]
    xf = x.reshape(-1, D)
    out = torch.zeros((B * T, D), dtype=torch.float32)
    start = 0
    for e, c in enumerate(counts[:E]):
        if c:
            tok, w = rows[start:start + c], wts[start:start + c]
            xe = xf[tok] * w
            up = common.cast(w_up[e], cfg)
            if cfg.mlp_act == "swiglu":
                h = F.silu(xe @ common.cast(w_gate[e], cfg)) * (xe @ up)
            else:
                h = F.gelu(xe @ up, approximate="tanh")
            ye = h @ common.cast(w_down[e], cfg)
            out.index_put_((tok,), ye.to(torch.float32)
                           * w.to(torch.float32), accumulate=True)
        start += c
    return out


@pytest.mark.parametrize("arch", ["phi3p5_moe_42b", "qwen3_moe_235b"])
def test_eager_moe_dispatch_is_bit_unchanged(arch):
    from repro_torch import configs
    from repro_torch.models import common, lm, moe

    cfg = configs.get_smoke(arch)
    gen = torch.Generator().manual_seed(3)
    model = lm.init_params(cfg, gen)
    p = model.blocks[0].moe
    x = torch.randn(2, 24, cfg.d_model, generator=gen).to(
        common.dtype(cfg.compute_dtype))
    wg = p.w_gate if cfg.mlp_act == "swiglu" else None
    for n_groups in (1, 3):
        got = moe._expert_sums(cfg, x, common.cast(p.router, cfg), wg,
                               p.w_up, p.w_down, n_groups=n_groups)
        want = _expert_sums_before(cfg, x, common.cast(p.router, cfg), wg,
                                   p.w_up, p.w_down, n_groups)
        assert torch.equal(got, want)


def test_fake_moe_takes_the_static_dispatch_rows():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.models import common, lm, moe

    cfg = configs.get_smoke("phi3p5_moe_42b")
    N, n = 64, 4                                   # 4 groups of 16 tokens
    C = moe.capacity(N // n, cfg)
    assert moe._static_rows(cfg, N, n, None) == min(C * n, N)
    assert moe._static_rows(cfg, N, n, (16, 32)) == -(-min(C * n, N)
                                                      * 16 // N)
    with FakeTensorMode():
        model = lm.LM(cfg)
        p = model.blocks[0].moe
        x = torch.zeros(4, 16, cfg.d_model,
                        dtype=common.dtype(cfg.compute_dtype))
        with FlopCounterMode(display=False) as fc:
            moe.moe_ffn(p, cfg, x, n_groups=n)
    rows = min(C * n, N)
    d, f = cfg.d_model, cfg.d_ff
    n_mats = 3 if cfg.mlp_act == "swiglu" else 2
    experts = 2 * rows * d * f * n_mats * cfg.num_experts
    router = 2 * N * d * cfg.num_experts
    assert fc.get_total_flops() == experts + router


# ---------------------------------------------------------------------------
# measure_remat_factor.
# ---------------------------------------------------------------------------
def test_measure_remat_factor():
    from repro_torch.launch import dryrun

    assert dryrun.measure_remat_factor("qwen1p5_0p5b", "full") == 4.0
    dots = dryrun.measure_remat_factor("qwen1p5_0p5b", "dots")
    assert 3.0 < dots < 4.0


# ---------------------------------------------------------------------------
# run_cell on fake CPU worlds, all cells in one subprocess.
# ---------------------------------------------------------------------------
# (id, arch, shape, run_cell keywords).  Every family's decode_32k and
# long_500k on 16x16 in the default mode (tp), and one prefill cell there
# (the families' train_4k and prefill_32k traces are cut: an eager trace
# runs every SSD chunk and attention block of the full length); one dense
# train cell in each training mode at T = 512 (a direct-attention step),
# pp on a (16, 2) mesh (the smoke config's two layers as two stages);
# tp_serve and auto; an MoE and a dense decode cell on 2x16x16.
CELLS = (
    [(f"{a}-{s}", a, s, {}) for a in FAMILIES
     for s in ("decode_32k", "long_500k")]
    + [("audio-prefill_32k", "whisper_small", "prefill_32k", {}),
       ("tp", "qwen1p5_0p5b", "train_4k", {"seq": 512}),
       ("fsdp", "qwen1p5_0p5b", "train_4k", {"mode": "fsdp", "seq": 512}),
       ("dp", "qwen1p5_0p5b", "train_4k", {"mode": "dp", "seq": 512}),
       ("pp", "qwen1p5_0p5b", "train_4k",
        {"mode": "pp", "mesh_name": "16x2", "seq": 512}),
       ("tp_serve", "qwen1p5_0p5b", "decode_32k", {"mode": "tp_serve"}),
       ("auto", "qwen1p5_0p5b", "train_4k", {"mode": "auto", "seq": 512}),
       ("moe-2x16x16", "phi3p5_moe_42b", "decode_32k", {"multi_pod": True}),
       ("dense-2x16x16", "qwen1p5_0p5b", "decode_32k",
        {"multi_pod": True})])

_PROGRAM = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib

out = {"cells": {}, "steps": {}}
for cid, arch, shape, kw in json.loads(sys.argv[1]):
    out["cells"][cid] = dryrun.run_cell(arch, shape, smoke=True,
                                        verbose=False, **kw)
# The dry run's 1x1 cells against one real step of the same cell on a
# one-rank gloo world: FlopCounterMode on the step.
for arch, shape, f32 in (("qwen1p5_0p5b", "train_4k", False),
                         ("qwen1p5_0p5b", "decode_32k", True),
                         ("zamba2_1p2b", "train_4k", False)):
    cfg = dryrun.cell_config(arch, f32, smoke=True)
    cell_shape = dryrun.cell_shape(shape, 2, 64)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = mesh_lib.make_debug_mesh(1, 1, device_type="cpu")
        cell = dryrun.build_cell(cfg, cell_shape, mesh, "tp",
                                 generator=torch.Generator().manual_seed(0))
        with FlopCounterMode(display=False) as fc:
            cell.step()
    finally:
        dist.destroy_process_group()
    rec = dryrun.run_cell(arch, shape, mesh_name="1x1", batch=2, seq=64,
                          f32=f32, smoke=True, verbose=False)
    out["steps"][f"{arch}-{shape}"] = [rec["status"], fc.get_total_flops(),
                                       rec.get("counted_flops_per_device")]
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _dry_run_proc():
    """The cells' subprocess, started with the module's first test so that
    it runs while the others do."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-c", _PROGRAM,
         json.dumps([[c, a, s, kw] for c, a, s, kw in CELLS])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def dry_runs(_dry_run_proc):
    out, err = _dry_run_proc.communicate(timeout=600)
    assert _dry_run_proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("cid", [c[0] for c in CELLS])
def test_dry_run_cell(dry_runs, cid):
    from repro_torch import configs
    from repro_torch.launch import dryrun

    _, arch, shape, kw = next(c for c in CELLS if c[0] == cid)
    rec = dry_runs["cells"][cid]
    reason = dryrun.skip_reason(configs.get_smoke(arch),
                                configs.get_shape(shape))
    if reason:
        from repro import configs as jconfigs
        from repro.launch import dryrun as jdryrun
        assert rec["status"] == "skipped"
        assert rec["reason"] == reason == jdryrun.skip_reason(
            jconfigs.get_smoke(arch), jconfigs.get_shape(shape))
        return
    assert rec["status"] == "ok", rec.get("traceback")
    mesh = kw.get("mesh_name") or ("2x16x16" if kw.get("multi_pod")
                                   else "16x16")
    assert rec["mesh"] == mesh and rec["devices"] == dryrun.mesh_size(mesh)
    assert rec["mode"] == dryrun.resolve_mode(
        kw.get("mode", "tp"), configs.get_smoke(arch),
        configs.get_shape(shape))
    for key in ("flops_per_device", "bytes_per_device",
                "counted_flops_per_device", "counted_bytes_per_device",
                "peak_bytes_per_device", "argument_bytes_per_device",
                "bound_seconds"):
        assert rec[key] > 0, key
    assert rec["peak_bytes_per_device"] >= rec["argument_bytes_per_device"]
    assert rec["bottleneck"] in ("t_compute", "t_memory", "t_collective")
    assert rec["bound_seconds"] == max(rec["t_compute"], rec["t_memory"],
                                       rec["t_collective"])
    assert rec["model_flops_per_device"] == pytest.approx(
        rec["model_flops_total"] / rec["devices"])
    if rec["mode"] == "pp":
        assert rec["pipeline_overhead"] == pytest.approx((2 + 2 - 1) / 2)
        assert rec["collectives"]["n_collective-permute"] > 0
    if rec["devices"] > 1 and rec["mode"] != "pp":
        assert rec["collectives"]["total_wire_bytes"] > 0


@pytest.mark.parametrize("step", ["qwen1p5_0p5b-train_4k",
                                  "qwen1p5_0p5b-decode_32k",
                                  "zamba2_1p2b-train_4k"])
def test_dry_run_counts_the_flops_of_a_real_step(dry_runs, step):
    status, real, counted = dry_runs["steps"][step]
    assert status == "ok"
    assert counted == real
