"""Multi-pod dry run of the port: trace one step of every (architecture x
input shape) cell on the production meshes, allocating nothing, and
extract the roofline's raw numbers.

The counterpart of the JAX package's ``launch/dryrun.py``.  Run it as its
own process: it makes a world of its own on the ``fake`` backend
(``FakeStore``), rank 0 of 256 (16x16) or 512 (2x16x16) ranks, which must
not meet another process group:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out results/dryrun_torch.jsonl

Each cell builds its parameters, optimizer moments, batch or decode cache
under ``FakeTensorMode`` as DTensors placed by the port's own rules
(``distributed/sharding.py``), on ``cuda`` where a card is present and
``cpu`` otherwise, and runs one step of the port's own program (train,
pp train through ``distributed/pipeline.py``, prefill, or decode through
``lm.serve_step``) under the policy of ``make_policy``, on rank 0.  Per
cell it records, by the reference's keys where the meaning is the same:

* ``flops_per_device`` / ``bytes_per_device``: the analytic counts
  (``distributed/analytic.py``) over the mesh, the roofline's numerators;
* ``counted_flops_per_device`` (``torch.utils.flop_counter``'s formulas
  on rank 0's local operations, what ``FlopCounterMode`` counts) and
  ``counted_bytes_per_device`` (each dispatched operation's input and
  output bytes: the eager program's traffic), in place of XLA's
  ``cost_analysis``;
* ``peak_bytes_per_device``: the most live storage on rank 0 during the
  step, parameters, moments, batch and cache included
  (``torch.distributed._tools.mem_tracker.MemTracker``);
  ``argument_bytes_per_device`` / ``output_bytes_per_device``: rank 0's
  bytes of the step's inputs and outputs;
* ``collectives``: rank 0's collective bytes by kind
  (``distributed/comm_analysis.py``), ``op_calls``: calls of the port's own
  operators (flash decode's partials and combine);
* ``model_flops_*``, ``useful_flops_ratio``, ``train_factor``,
  ``pipeline_overhead`` (pp) and the roofline terms (``t_compute``,
  ``t_memory``, ``t_collective``, ``bottleneck``, ``bound_seconds``,
  ``compute_fraction``) on an NVIDIA H100's constants: predictions, not
  measurements;
* ``trace_s`` in place of ``lower_s`` / ``compile_s``.

``--explicit-out`` and ``--raw-wire`` have no counterpart (the port
updates parameters in place, keeping their placements; its collectives
carry the program's own dtypes): a record made with either says so.
``--mesh DxM`` traces on a (D, M) mesh of D x M fake ranks, and
``--batch`` / ``--seq`` / ``--f32`` change a shape's batch and length and
the config's dtypes, so that a cell can be held to a step a card ran
(``run_cell(..., smoke=True)`` takes an architecture's reduced config, as
the CPU tests do).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.configs.base import InputShape
from repro_torch.distributed import analytic, comm_analysis, sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm
from repro_torch.training import optim

MESHES = {"single": ["16x16"], "multi": ["2x16x16"],
          "both": ["16x16", "2x16x16"]}


def skip_reason(cfg, shape: InputShape) -> str | None:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("long_500k requires sub-quadratic attention; "
                f"{cfg.name} is pure full-attention (DESIGN.md "
                "SArch-applicability)")
    return None


def device_type() -> str:
    """The cells' device: ``cuda`` where a card is present, else ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def mesh_size(mesh_name: str) -> int:
    return math.prod(int(n) for n in mesh_name.split("x"))


def make_mesh(mesh_name: str, dev_type: str):
    """"16x16" / "2x16x16": the production meshes; "DxM": a (D, M)
    ("data", "model") mesh, over the current world."""
    if mesh_name in ("16x16", "2x16x16"):
        return mesh_lib.make_production_mesh(
            multi_pod=mesh_name == "2x16x16", device_type=dev_type)
    d, m = (int(n) for n in mesh_name.split("x"))
    return mesh_lib.make_debug_mesh(d, m, device_type=dev_type)


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """Rank 0 of a world of ``n_ranks`` on the ``fake`` backend: every
    collective returns at once and moves nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake world; run it in "
                           "a process without a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _traceable_dtensor():
    """DTensor's metadata work, run apart from the step's fake mode.

    DTensor derives an operation's output shape by running it on
    global-shape fake tensors under the active fake mode, where a memory
    tracker or recorder would take them for the step's (a train step's
    global logits alone are hundreds of GB); and it computes a strided
    shard's offsets from a real index tensor, whose ``.tolist()`` a fake
    mode refuses.  Both run here with the step's dispatch modes set aside:
    the first under a fake mode of its own, the second on real tensors.
    Neither computes any of the step's values."""
    from torch.distributed.tensor import _sharding_prop, placement_types
    from torch.utils._python_dispatch import _disable_current_modes

    patched = []
    for owner, name in (
            (_sharding_prop.ShardingPropagator,
             "_propagate_tensor_meta_non_cached"),
            (getattr(placement_types, "_StridedShard", None),
             "local_shard_size_and_offset")):
        orig = getattr(owner, name, None)
        if orig is None:
            continue

        def apart(*a, _orig=orig, **kw):
            with _disable_current_modes():
                return _orig(*a, **kw)

        setattr(owner, name, apart)
        patched.append((owner, name, orig))
    try:
        yield
    finally:
        for owner, name, orig in patched:
            setattr(owner, name, orig)


def cell_config(arch: str, f32: bool = False, smoke: bool = False):
    """A cell's config: the architecture's (its reduced one with
    ``smoke``), with float32 parameters and compute with ``f32``."""
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    if f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    return cfg


def cell_shape(shape_name: str, batch=None, seq=None) -> InputShape:
    """The named input shape, with another global batch or length."""
    shape = configs.get_shape(shape_name)
    return dataclasses.replace(
        shape, global_batch=batch or shape.global_batch,
        seq_len=seq or shape.seq_len)


def _batch(cfg, B: int, T: int, train: bool, device):
    """A (B, T) int32 batch (labels too for ``train``) with the frontend
    stub of audio / vlm, zeros on ``device``."""
    act = getattr(torch, cfg.compute_dtype)
    ids = lambda: torch.zeros((B, T), dtype=torch.int32, device=device)
    batch = {"tokens": ids()}
    if train:
        batch["labels"] = ids()
    if cfg.family in ("audio", "vlm"):
        key, S = (("frames", cfg.encoder_seq) if cfg.family == "audio"
                  else ("patches", cfg.vision_seq))
        batch[key] = torch.zeros((B, S, cfg.d_model), dtype=act,
                                 device=device)
    return batch


def input_specs(arch: str, shape_name: str, mesh, mode: str = "tp", *,
                cfg=None, shape: InputShape | None = None):
    """Every model input of a cell as DTensors placed by the port's rules
    (``batch_sharding`` for a batch, ``cache_shardings`` for a decode
    cache, cross K/V included); under a ``FakeTensorMode`` they allocate
    nothing.  Decode: ``token`` (B,) int32, the same on every rank, and
    ``cache``, an ``lm.Cache`` at ``pos = T - 1``, so that the step attends
    over all T rows (the reference's masked attention reads them all)."""
    cfg = cfg or configs.get(arch)
    shape = shape or configs.get_shape(shape_name)
    B, T, dev = shape.global_batch, shape.seq_len, mesh.device_type
    if shape.kind in ("train", "prefill"):
        return sharding.place_batch(
            _batch(cfg, B, T, shape.kind == "train", dev), mesh, mode=mode)
    cache = lm.init_cache(cfg, B, T, device=dev)
    if lm.cross_sites(cfg):
        S = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_seq
        xkv = (lm.cross_sites(cfg), B, S, cfg.num_kv_heads, cfg.hd())
        act = getattr(torch, cfg.compute_dtype)
        cache = cache._replace(
            cross_k=torch.zeros(xkv, dtype=act, device=dev),
            cross_v=torch.zeros(xkv, dtype=act, device=dev))
    return {"token": torch.zeros((B,), dtype=torch.int32, device=dev),
            "cache": sharding.place_cache(cache, mesh, batch=B)._replace(
                pos=T - 1)}


def model_flops(cfg, shape: InputShape) -> float:
    """MODEL_FLOPS: 6*N_active*D tokens (train) / 2*N_active*B (decode)."""
    n = cfg.param_count()
    if cfg.num_experts:
        inactive = (cfg.num_layers * (cfg.num_experts - cfg.experts_per_token)
                    * 3 * cfg.d_model * cfg.d_ff)
        n = n - inactive
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token / sequence


_REMAT_FACTOR_CACHE: dict = {}


def measure_remat_factor(arch: str, remat: str) -> float:
    """Measured train factor (fwd+bwd+recompute) for a remat policy.

    Counts one single-device train step of the smoke config at B = 2,
    T = 128 with ``FlopCounterMode`` (under a fake mode: nothing is
    allocated) with remat='full' (factor 4 by construction) and with the
    requested policy, and scales: factor = 4 * flops(policy) /
    flops(full).  Eager layers run every trip, so nothing needs
    unrolling.  Memoized per (arch, remat)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    if remat in ("full", True):
        return 4.0
    key = (arch, remat)
    if key in _REMAT_FACTOR_CACHE:
        return _REMAT_FACTOR_CACHE[key]
    cfg = configs.get_smoke(arch)
    opt = optim.Adam(lr=1e-4)

    def flops_for(policy):
        with FakeTensorMode():
            model = lm.LM(cfg, device="cpu", dtype=torch.float32)
            state = opt.init(dict(model.named_parameters()))
            batch = _batch(cfg, 2, 128, True, "cpu")
            with FlopCounterMode(display=False) as fc:
                lm.train_step(model, state, batch, cfg, opt, remat=policy)
        return float(fc.get_total_flops())

    f_full, f_pol = flops_for("full"), flops_for(remat)
    factor = 4.0 * (f_pol / f_full) if f_full else 4.0
    _REMAT_FACTOR_CACHE[key] = factor
    return factor


def resolve_mode(mode: str, cfg, shape: InputShape) -> str:
    """'auto' = the reference's winning strategy per cell class:

    * train, replica fits comfortably on a chip (< 4 GB bf16) -> ``dp``;
    * train, dense + large -> ``fsdp`` (ZeRO-3);
    * train, MoE + large -> ``tp`` (expert parallelism: only routed
      tokens move);
    * prefill/decode -> ``tp_serve`` (params never re-gathered).
    """
    if mode != "auto":
        return mode
    if shape.kind == "train":
        if cfg.param_count() * 2 < 4e9:
            return "dp"
        return "tp" if cfg.num_experts else "fsdp"
    return "tp_serve"


class Cell(NamedTuple):
    """One cell's step, ready to run: ``step()`` runs it once and returns
    its outputs; ``inputs`` are its arguments (what a memory tracker must
    know to be live before it); ``pipeline_overhead`` the pipeline's
    bubble factor (pp), else None."""

    step: Callable[[], Any]
    inputs: tuple
    pipeline_overhead: Optional[float] = None


def _model(cfg, dev, dtype, generator):
    """The cell's model: uninitialized in a fake trace, initialized from
    ``generator`` for a step that runs."""
    if generator is None:
        return lm.LM(cfg, device=dev, dtype=dtype)
    return lm.init_params(cfg, generator, device=dev, dtype=dtype)


def build_cell(cfg, shape: InputShape, mesh, mode: str, *, sp: bool = True,
               moe_group: int = 256, remat: str = "full",
               generator: torch.Generator | None = None) -> Cell:
    """One cell's parameters, moments and inputs on ``mesh``, placed by the
    port's rules in ``mode`` (tp | tp_serve | fsdp | dp | pp; 'auto'
    resolved), and its step: the port's own program for the cell's kind.
    Under a ``FakeTensorMode`` nothing is allocated; with a
    ``generator`` (real tensors on a world of real ranks) the parameters
    are initialized, so that the same step can run."""
    dev = mesh.device_type
    B, T = shape.global_batch, shape.seq_len
    ngroups = max(1, B * T // moe_group)
    if shape.kind == "train" and mode == "pp":
        from repro_torch.distributed import pipeline
        opt = optim.Adam(lr=1e-4)
        params = pipeline._from_full(
            _model(cfg, dev, torch.float32, generator), cfg, mesh)
        state = pipeline.opt_init(params, opt)
        n_micro = mesh.size(mesh_lib.axis_names(mesh).index("model"))
        step = pipeline.make_pp_train_step(cfg, opt, mesh, n_micro=n_micro)
        batch = _batch(cfg, B, T, True, dev)
        return Cell(lambda: step(params, state, batch),
                    (params, state, batch), step.pipeline_overhead)
    pol = sharding.make_policy(mesh, batch=B, kind=shape.kind, sp=sp,
                               mode=mode)
    specs = input_specs(cfg.name, shape.name, mesh, mode, cfg=cfg,
                        shape=shape)
    if shape.kind == "train":
        opt = optim.Adam(lr=1e-4)
        model = _model(cfg, dev, torch.float32, generator)
        state = opt.init(dict(model.named_parameters()))
        sharding.distribute_model(model, mesh, mode)
        state = sharding.distribute_opt_state(state, model)
        return Cell(lambda: lm.train_step(model, state, specs, cfg, opt,
                                          pol=pol, moe_groups=ngroups,
                                          remat=remat),
                    (model, state, specs))
    model = _model(cfg, dev, None, generator)
    sharding.distribute_model(model, mesh, mode)
    if shape.kind == "prefill":
        aux = {k: v for k, v in specs.items() if k != "tokens"}
        return Cell(lambda: lm.prefill(model, cfg, specs["tokens"],
                                       aux or None, moe_groups=ngroups,
                                       pol=pol),
                    (model, specs))
    cache, token = specs["cache"], specs["token"]
    return Cell(lambda: lm.serve_step(model, cache, token, cfg, pol=pol),
                (model, cache, token))


def _tensors(tree):
    """The tensors of a tree of modules, dicts, tuples and lists (each
    module's parameters and buffers)."""
    out = []
    for leaf in pytree.tree_leaves(tree, is_leaf=lambda x: isinstance(
            x, torch.nn.Module)):
        if isinstance(leaf, torch.nn.Module):
            out += list(leaf.parameters()) + list(leaf.buffers())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def local_bytes(tree) -> int:
    """Rank 0's bytes of the tensors of ``tree`` (a DTensor counts its
    local shard), each storage once."""
    seen, total = set(), 0
    for t in _tensors(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def trace_step(cell: Cell) -> dict:
    """Run ``cell``'s step once under a memory tracker and a
    :class:`comm_analysis.StepRecorder`: its outputs' and inputs' bytes,
    the peak of live storage (the inputs already live), the recorder."""
    from torch.distributed._tools.mem_tracker import MemTracker

    mt = MemTracker()
    mt.track_external(*_tensors(cell.inputs))
    rec = comm_analysis.StepRecorder()
    t0 = time.perf_counter()
    with _traceable_dtensor(), mt, rec:
        out = cell.step()
    trace_s = time.perf_counter() - t0
    peak = sum(snap["Total"] for snap in
               mt.get_tracker_snapshot("peak").values())
    return {"trace_s": trace_s, "peak": peak, "recorder": rec,
            "argument_bytes": local_bytes(cell.inputs),
            "output_bytes": local_bytes(out)}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
             mesh_name: str | None = None, sp: bool = True,
             moe_group: int = 256, mode: str = "tp",
             explicit_out: bool = False, raw_wire: bool = False,
             remat: str = "full", batch: int | None = None,
             seq: int | None = None, f32: bool = False,
             smoke: bool = False, verbose: bool = True) -> dict:
    """Trace one cell on rank 0 of a fake world of the mesh's size (16x16,
    or 2x16x16 with ``multi_pod``; ``mesh_name`` "DxM" for another) and
    return its record."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cell_config(arch, f32, smoke)
    shape = cell_shape(shape_name, batch, seq)
    mode = resolve_mode(mode, cfg, shape)
    mesh_name = mesh_name or ("2x16x16" if multi_pod else "16x16")
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "mode": mode, "remat": remat, "status": "ok"}
    if batch or seq or f32 or smoke:
        rec.update(batch=shape.global_batch, seq=shape.seq_len,
                   compute_dtype=cfg.compute_dtype, smoke=smoke)
    if explicit_out:
        rec["explicit_out"] = ("no counterpart: the port updates parameters "
                               "in place, keeping their placements")
    if raw_wire:
        rec["raw_wire"] = ("no counterpart: the port's collectives carry "
                           "the program's own dtypes")
    reason = skip_reason(cfg, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec
    n_dev = mesh_size(mesh_name)
    dev_type = device_type()
    try:
        with fake_world(n_dev):
            mesh = make_mesh(mesh_name, dev_type)
            with FakeTensorMode(allow_non_fake_inputs=True):
                t0 = time.perf_counter()
                cell = build_cell(cfg, shape, mesh, mode, sp=sp,
                                  moe_group=moe_group, remat=remat)
                build_s = time.perf_counter() - t0
                traced = trace_step(cell)
        tr = traced["recorder"]
        tf = (measure_remat_factor(arch, remat)
              if shape.kind == "train" else 4.0)
        rec["train_factor"] = tf
        an = analytic.summarize(cfg, shape, n_dev, moe_group=moe_group,
                                train_factor=tf)
        flops_dev = an["flops_per_device"]
        bytes_dev = an["bytes_per_device"]
        if cell.pipeline_overhead is not None:
            # GPipe bubble: the reference's SPMD schedule executes
            # (M+S-1)/M x the useful per-stage work; its roofline charges
            # the compute term for it, and so does this one.
            rec["pipeline_overhead"] = cell.pipeline_overhead
            flops_dev *= cell.pipeline_overhead
        coll = comm_analysis.collective_stats(tr.collectives)
        mf = model_flops(cfg, shape)
        terms = comm_analysis.roofline_terms(flops_dev, bytes_dev,
                                             coll["total_wire_bytes"])
        rec.update(
            devices=n_dev, device_type=dev_type,
            build_s=round(build_s, 2), trace_s=round(traced["trace_s"], 2),
            flops_per_device=flops_dev, bytes_per_device=bytes_dev,
            counted_flops_per_device=float(tr.flops),
            counted_bytes_per_device=float(tr.bytes),
            peak_bytes_per_device=int(traced["peak"]),
            argument_bytes_per_device=int(traced["argument_bytes"]),
            output_bytes_per_device=int(traced["output_bytes"]),
            collectives=coll, op_calls=dict(tr.calls),
            model_flops_total=mf,
            model_flops_per_device=mf / n_dev,
            useful_flops_ratio=(mf / n_dev) / flops_dev if flops_dev else 0,
            **terms,
        )
    except Exception as e:  # noqa: BLE001 -- record the failure, keep going
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    if verbose:
        print(json.dumps(roofline_line(rec)), flush=True)
    return rec


def roofline_line(rec: dict) -> dict:
    """The keys of a record that one line prints."""
    return {k: rec.get(k) for k in
            ("arch", "shape", "mesh", "mode", "status", "trace_s",
             "bottleneck", "bound_seconds", "compute_fraction",
             "peak_bytes_per_device")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    help="single (16x16) | multi (2x16x16) | both | DxM")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence parallelism (perf ablation)")
    ap.add_argument("--moe-group", type=int, default=256)
    ap.add_argument("--mode", default="tp",
                    choices=["tp", "tp_serve", "fsdp", "dp", "pp", "auto"],
                    help="sharding strategy (pp = GPipe stages on the model "
                         "axis, dense train; auto = the reference's winning "
                         "strategy per cell class)")
    ap.add_argument("--explicit-out", action="store_true",
                    help="no counterpart in the port (the record says so)")
    ap.add_argument("--raw-wire", action="store_true",
                    help="no counterpart in the port (the record says so)")
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"],
                    help="activation-checkpoint policy for train cells")
    ap.add_argument("--batch", type=int, default=None,
                    help="the shape's global batch instead of its own")
    ap.add_argument("--seq", type=int, default=None,
                    help="the shape's length (decode: cache rows) instead "
                         "of its own")
    ap.add_argument("--f32", action="store_true",
                    help="float32 parameters and compute")
    args = ap.parse_args(argv)

    if args.mesh in MESHES:
        meshes = MESHES[args.mesh]
    else:
        try:
            d, m = (int(n) for n in args.mesh.split("x"))
        except ValueError:
            ap.error(f"--mesh {args.mesh!r}: single, multi, both or DxM")
        meshes = [f"{d}x{m}"]
    archs = (configs.ARCH_IDS if args.arch == "all"
             else [configs.canonical(a) for a in args.arch.split(",")])
    shapes = ([s.name for s in configs.SHAPES] if args.shape == "all"
              else args.shape.split(","))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_fail = 0
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mesh_name in meshes:
                    rec = run_cell(arch, shape, mesh_name=mesh_name,
                                   sp=not args.no_sp,
                                   moe_group=args.moe_group, mode=args.mode,
                                   explicit_out=args.explicit_out,
                                   raw_wire=args.raw_wire, remat=args.remat,
                                   batch=args.batch, seq=args.seq,
                                   f32=args.f32)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    n_fail += rec["status"] == "error"
    print(f"done; {n_fail} errors", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
