"""Pipeline parallelism (GPipe) for dense-family training over
``torch.distributed`` ranks.

The counterpart of the JAX package's ``distributed/pipeline.py``.  The
``model`` axis of a ``DeviceMesh`` is the stage axis (S stages); ``data``
(x ``pod``) stays data-parallel.  Stage ``s`` holds layers ``[s L / S,
(s + 1) L / S)`` for good (L % S == 0), the embedding is replicated, and
only the (microbatch, T, D) boundary activations cross between stages.
One train step, on each rank:

  1. embed the rank's batch shard (its rows by its data coordinate) and
     split it into M microbatches;
  2. forward, microbatch by microbatch: stage 0 takes the embedding, a
     later stage receives its input from the stage before, runs its
     layers (rematerialized, as the reference's stage forward is) and
     sends the output on -- hand-written ``send`` / ``recv`` over the
     ranks of the ``model`` axis, not ``torch.distributed.pipelining``;
  3. after the pipeline drains, the last stage runs the chunked
     cross-entropy once over its microbatches' outputs (as the
     reference does, not once a tick);
  4. backward, microbatch by microbatch in reverse: the last stage
     back-propagates its loss, a stage before it receives the gradient of
     its output from the stage after, and each sends the gradient of its
     input back;
  5. block gradients are summed over the data axes only; embedding
     gradients over the data axes and ``model`` (stage 0 holds the
     embedding's, the last stage the final norm's and unembedding's, the
     others zero); the loss is the last stage's NLL sum over all ranks,
     over B * T.

The reference runs its schedule SPMD-masked: every stage computes every
one of the M + S - 1 ticks, so ``pipeline_overhead = (M + S - 1) / M`` of
the useful work is charged for the bubble.  Here a stage idles in the
bubble instead of computing a masked tick; the attribute keeps the
reference's factor (the dry run's roofline charges it).

Scope: the dense family (GQA attention + MLP), as in the reference.
Master weights are float32, as in the port's other train steps (the
reference's ``init_pp`` casts to ``param_dtype``; its Adam then promotes
bfloat16 back to float32).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import common, lm


class PPModel(nn.Module):
    """A stage's parameters: ``embed`` (replicated) and ``blocks``, the
    stage's L / S dense blocks (``first`` is the first one's layer)."""

    def __init__(self, cfg, first: int, n: int, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.first = first
        scfg = common.stored(cfg, dtype)
        self.embed = common.Embed(scfg, device)
        self.blocks = nn.ModuleList(lm.Block(scfg, device)
                                    for _ in range(n))


def _stage(cfg, mesh) -> Tuple[int, int, int]:
    """(stage id, stage count, layers a stage)."""
    if cfg.family != "dense":
        raise ValueError("PP stages implemented for dense family, not "
                         f"{cfg.family!r}")
    S = mesh.size(mesh_lib.axis_names(mesh).index("model"))
    if cfg.num_layers % S:
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple "
                         f"of the {S} stages")
    sid = mesh.get_local_rank("model")
    return sid, S, cfg.num_layers // S


def _from_full(full: lm.LM, cfg, mesh) -> PPModel:
    sid, S, per = _stage(cfg, mesh)
    ref = next(iter(full.parameters()))
    out = PPModel(cfg, sid * per, per, device="meta", dtype=ref.dtype)
    out.embed = full.embed
    out.blocks = nn.ModuleList(full.blocks[sid * per:(sid + 1) * per])
    return out


def init_pp(generator: torch.Generator, cfg, optimizer, mesh,
            device="cpu"):
    """Dense params split into the PP layout and its optimizer state
    ``(opt_blocks, opt_embed)``.  Every rank draws the whole model from
    ``generator`` (the same seed everywhere) and keeps its stage."""
    params = _from_full(lm.init_params(cfg, generator, device=device,
                                       dtype=torch.float32), cfg, mesh)
    return params, opt_init(params, optimizer)


def params_from_jax(tree, cfg, mesh, device="cpu") -> Tuple[PPModel, Dict]:
    """The stage of ``mesh``'s rank of a reference tree (the layout of
    ``repro.models.lm.init_params``), as float32 master weights."""
    return _from_full(lm.params_from_jax(tree, cfg, device=device,
                                         dtype=torch.float32), cfg, mesh)


def opt_init(params: PPModel, optimizer):
    """The optimizer state of a PP model: ``(opt_blocks, opt_embed)``."""
    return (optimizer.init(_named(params.blocks, "blocks")),
            optimizer.init(_named(params.embed, "embed")))


def _named(module, prefix) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": p for k, p in module.named_parameters()}


def pp_shardings(mesh, params: PPModel, opt_state=None):
    """Specs of the PP layout, per parameter name, in the reference's
    stacked terms: the blocks' layer axis on ``model`` (``("model",)``),
    the embedding replicated (``()``); with ``opt_state``, the moments'
    specs as their parameters' and the step counts replicated."""
    psh = {**{k: ("model",) for k in _named(params.blocks, "blocks")},
           **{k: () for k in _named(params.embed, "embed")}}
    if opt_state is None:
        return psh
    osh = tuple({"step": (), "mu": {k: psh[k] for k in o.mu},
                 "nu": {k: psh[k] for k in o.nu}} for o in opt_state)
    return psh, osh


def _neighbours(mesh):
    """Global ranks of the previous and next stage (None at the ends)."""
    grp = mesh.get_group("model")
    sid = mesh.get_local_rank("model")
    S = dist.get_world_size(grp)
    at = lambda s: dist.get_global_rank(grp, s)
    return (at(sid - 1) if sid > 0 else None,
            at(sid + 1) if sid < S - 1 else None)


def _data_shard(mesh, B: int) -> Tuple[int, int]:
    """This rank's rows of a (B, ...) batch: its data coordinate's block
    (row-major over the data axes)."""
    names = mesh_lib.axis_names(mesh)
    idx, n = 0, 1
    for ax in mesh_lib.data_axes(mesh):
        if ax in names:
            size = mesh.size(names.index(ax))
            idx = idx * size + mesh.get_local_rank(ax)
            n *= size
    if B % n:
        raise ValueError(f"batch {B} does not split over {n} data ranks")
    b = B // n
    return idx * b, (idx + 1) * b


def _all_reduce(tensors, mesh, axes):
    """Sum each tensor in place over the mesh axes ``axes`` (one axis
    after another)."""
    for ax in axes:
        grp = mesh.get_group(ax)
        for t in tensors:
            dist.all_reduce(t, group=grp)


def make_pp_train_step(cfg, optimizer, mesh, *, n_micro: int):
    """The pipelined train step of a dense-family config:
    ``train_step(params, opt_state, batch) -> (params, opt_state, loss)``.

    params: a :class:`PPModel` (:func:`init_pp`); opt_state:
    ``(opt_blocks, opt_embed)``; batch: {"tokens": (B, T), "labels":
    (B, T)}, the whole batch on every rank (each takes its data shard).
    Params and moments are updated in place; the loss is the global mean
    NLL, the same on every rank.  As in the reference, the blocks and the
    embedding are two optimizer updates; an optimizer that clips clips
    both by the norm of the whole gradient (every stage's blocks and the
    embedding), where the reference's two updates clip each part by its
    own norm, and the blocks by their stage's alone (without clipping, as
    in the reference's test, the two agree).
    """
    sid, S, _ = _stage(cfg, mesh)
    M = n_micro
    prev, nxt = _neighbours(mesh)
    names = mesh_lib.axis_names(mesh)
    data = [a for a in names if a != "model"]
    clip = getattr(optimizer, "clip_norm", None)
    update = (dataclasses.replace(optimizer, clip_norm=None)
              if clip is not None else optimizer)

    def train_step(params: PPModel, opt_state, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        B_glob, T = tokens.shape
        lo, hi = _data_shard(mesh, B_glob)
        tokens, labels = tokens[lo:hi], labels[lo:hi]
        if (hi - lo) % M:
            raise ValueError(f"local batch {hi - lo} is not a multiple "
                             f"of n_micro {M}")
        mb = (hi - lo) // M
        blocks = _named(params.blocks, "blocks")
        embed = _named(params.embed, "embed")
        for p in (*blocks.values(), *embed.values()):
            p.requires_grad_(True)
            p.grad = None
        dev = tokens.device
        cos_sin = common.rope_tables(lm._positions(mb, T, dev), cfg.hd(),
                                     cfg.rope_theta)
        body = lambda lp, h: lm._attn_block(lp, cfg, h, cos_sin)
        shape = (mb, T, cfg.d_model)
        dt = common.dtype(cfg.compute_dtype)
        ins, outs = [], []
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        with torch.enable_grad():
            x = common.embed(params.embed, cfg, tokens) if sid == 0 else None
            for m in range(M):                                # forward
                if sid == 0:
                    h = x[m * mb:(m + 1) * mb]
                else:
                    h = torch.empty(shape, dtype=dt, device=dev)
                    dist.recv(h, src=prev)
                    h.requires_grad_(True)
                ins.append(h)
                out = lm._run_stack(params.blocks, body, h, remat=True)
                if nxt is not None:
                    dist.send(out.detach().contiguous(), dst=nxt)
                outs.append(out)
            if nxt is None:
                # The last stage: CE once, after the pipeline drains, and
                # one backward through every microbatch.
                loss_sum = sum(_ce_sum(params.embed, cfg, outs[m],
                                       labels[m * mb:(m + 1) * mb])
                               for m in range(M))
                (loss_sum / (B_glob * T)).backward()
            for m in reversed(range(M)):                      # backward
                if nxt is not None:
                    g = torch.empty(shape, dtype=dt, device=dev)
                    dist.recv(g, src=nxt)
                    # Stage 0's microbatches share the embedding's graph.
                    torch.autograd.backward(outs[m], g,
                                            retain_graph=sid == 0 and m > 0)
                if prev is not None:
                    dist.send(ins[m].grad.contiguous(), dst=prev)
        g_blocks = {k: _grad(p) for k, p in blocks.items()}
        g_embed = {k: _grad(p) for k, p in embed.items()}
        _all_reduce(g_blocks.values(), mesh, data)
        _all_reduce(g_embed.values(), mesh, names)
        loss = loss_sum.detach().clone()
        _all_reduce([loss], mesh, names)
        for p in (*blocks.values(), *embed.values()):
            p.requires_grad_(False)
            p.grad = None
        if clip is not None:
            # The whole gradient's norm: the stages' block sums of squares
            # added over model, the (replicated) embedding's once.
            sq = sum(g.square().sum() for g in g_blocks.values())
            _all_reduce([sq], mesh, ["model"])
            sq = sq + sum(g.square().sum() for g in g_embed.values())
            scale = torch.clamp_max(clip / (torch.sqrt(sq) + 1e-9), 1.0)
            g_blocks = {k: g * scale for k, g in g_blocks.items()}
            g_embed = {k: g * scale for k, g in g_embed.items()}
        ob, oe = opt_state
        ob = update.update_(g_blocks, ob, blocks)
        oe = update.update_(g_embed, oe, embed)
        return params, (ob, oe), loss / (B_glob * T)

    train_step.pipeline_overhead = (M + S - 1) / M
    return train_step


def _grad(p):
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _ce_sum(embed, cfg, h, labels):
    """Summed NLL of (mb, T, D) hidden states: the chunked cross-entropy
    of ``lm.lm_loss`` (chunks under ``checkpoint``)."""
    T = h.shape[1]
    ck = min(lm.CE_CHUNK, T)
    while T % ck:
        ck -= 1
    total = None
    for i in range(0, T, ck):
        nll = torch.utils.checkpoint.checkpoint(
            lm._chunk_nll, embed, cfg, h[:, i:i + ck], labels[:, i:i + ck],
            use_reentrant=False)
        total = nll if total is None else total + nll
    return total
