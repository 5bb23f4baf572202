"""Closed-form FLOPs / HBM-bytes accounting per (arch x shape) cell.

The counterpart of the JAX package's ``distributed/analytic.py``: the same
formulas, so every number equals the reference's.  Why the roofline
numerators stay analytic in the port: the dry run
(``repro_torch.launch.dryrun``) traces one eager step on rank 0 of a fake
world, and that trace counts only what ran on rank 0 -- its own shards,
the experts and tokens that landed there, the pipeline stage it holds --
while the analytic count is the whole step's work over the mesh, the
yardstick both packages share.  The rank-0 counts are recorded beside it
(``counted_flops_per_device``, ``counted_bytes_per_device``).

We wrote every matmul, so the counts are exact for the reference's
lowering, including the costs a naive 6ND estimate misses: full-T^2
blockwise attention (no causal-block skipping), MoE dispatch/combine
einsums and capacity overprovisioning, SSD intra-chunk quadratic work,
remat recompute, and the chunked-CE unembed.  Collective traffic is not
estimated here: the dry run records it from the step's collectives
(``comm_analysis.py``); this module only provides the compute and memory
terms.

Conventions: counts are GLOBAL per step; divide by mesh size for
per-device.  Train factor: fwd(1) + bwd(2) + remat-recompute(1) = 4x
forward matmul FLOPs for everything under a checkpoint (all blocks, CE);
optimizer adds ~12 flops/param.  bf16 = 2 bytes; optimizer state f32.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import moe as moe_lib

TRAIN_FACTOR = 4.0     # fwd + 2x bwd + 1x remat recompute
BF16 = 2
F32 = 4


def _attn_layer_flops(cfg: ArchConfig, B: int, T: int, ctx: int) -> float:
    """One attention block forward: projections + full-block scores/ctx."""
    d, hd, H, Kv = cfg.d_model, cfg.hd(), cfg.num_heads, cfg.num_kv_heads
    N = B * T
    proj = 2.0 * N * d * hd * (H + 2 * Kv) + 2.0 * N * H * hd * d
    scores = 2.0 * B * T * ctx * H * hd * 2  # QK^T and PV, full blocks
    return proj + scores


def _mlp_flops(cfg: ArchConfig, B: int, T: int) -> float:
    n_mats = 3 if cfg.mlp_act == "swiglu" else 2
    return 2.0 * B * T * cfg.d_model * cfg.d_ff * n_mats


def _moe_flops(cfg: ArchConfig, B: int, T: int, group: int) -> float:
    N = B * T
    d, f = cfg.d_model, cfg.d_ff
    E, k, cf = cfg.num_experts, cfg.experts_per_token, cfg.moe_capacity_factor
    g = min(group, N)
    C = moe_lib.capacity(g, cfg)
    router = 2.0 * N * d * E
    dispatch = 2.0 * N * (E * C / g) * d * 2          # dispatch + combine
    n_mats = 3 if cfg.mlp_act == "swiglu" else 2
    experts = 2.0 * (N / g) * E * C * d * f * n_mats
    return router + dispatch + experts


def _mamba_layer_flops(cfg: ArchConfig, B: int, T: int) -> float:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = di // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    S = cfg.ssm_state
    Q = min(cfg.ssm_chunk, T)
    nc = max(T // Q, 1)
    N = B * T
    proj = 2.0 * N * d * (2 * di + 2 * S + H) + 2.0 * N * di * d
    conv = 2.0 * N * (di + 2 * S) * 4
    intra = 2.0 * B * nc * Q * Q * (S + H * P)        # CB scores + W.x
    states = 2.0 * B * nc * Q * H * P * S * 2         # chunk states + inter
    return proj + conv + intra + states


def _unembed_flops(cfg: ArchConfig, B: int, T: int) -> float:
    return 2.0 * B * T * cfg.d_model * cfg.vocab_size


def flops_cell(cfg: ArchConfig, shape: InputShape,
               moe_group: int = 256,
               train_factor: float = TRAIN_FACTOR) -> Dict[str, float]:
    """Global FLOPs for one step of this cell, by component.

    ``train_factor``: fwd(1) + bwd(2) + remat-recompute(r).  4.0 for full
    per-layer remat; for the 'dots' policy (matmul outputs saved) the
    recompute term drops to the non-dot ops -- the dry run measures the
    actual ratio on a reduced config and passes it here.
    """
    B, T = shape.global_batch, shape.seq_len
    fam = cfg.family
    out: Dict[str, float] = {}

    if shape.kind in ("train", "prefill"):
        ctx = T
        if fam in ("dense", "moe"):
            attn = cfg.num_layers * _attn_layer_flops(cfg, B, T, ctx)
            ffn = cfg.num_layers * (
                _moe_flops(cfg, B, T, moe_group) if fam == "moe"
                else _mlp_flops(cfg, B, T))
            out = {"attention": attn, "ffn": ffn}
        elif fam == "ssm":
            out = {"ssm": cfg.num_layers * _mamba_layer_flops(cfg, B, T)}
        elif fam == "hybrid":
            n_sites = cfg.num_layers // cfg.shared_attn_period
            out = {"ssm": cfg.num_layers * _mamba_layer_flops(cfg, B, T),
                   "attention": n_sites * (_attn_layer_flops(cfg, B, T, ctx)
                                           + _mlp_flops(cfg, B, T))}
        elif fam == "audio":
            Se = cfg.encoder_seq
            enc = cfg.encoder_layers * (_attn_layer_flops(cfg, B, Se, Se)
                                        + _mlp_flops(cfg, B, Se))
            dec = cfg.num_layers * (
                _attn_layer_flops(cfg, B, T, T)            # self
                + _attn_layer_flops(cfg, B, T, Se)         # cross
                + 2 * _mlp_flops(cfg, B, T))
            out = {"encoder": enc, "decoder": dec}
        elif fam == "vlm":
            Sv = cfg.vision_seq
            n_cross = cfg.num_layers // cfg.cross_attn_period
            n_self = cfg.num_layers - n_cross
            out = {"attention": n_self * (_attn_layer_flops(cfg, B, T, T)
                                          + _mlp_flops(cfg, B, T)),
                   "cross": n_cross * (_attn_layer_flops(cfg, B, T, Sv)
                                       + _mlp_flops(cfg, B, T))}
        if shape.kind == "train":
            out["unembed_ce"] = _unembed_flops(cfg, B, T)
            out = {k: v * train_factor for k, v in out.items()}
            n_params = cfg.param_count()
            out["optimizer"] = 12.0 * n_params
        else:
            out["unembed_ce"] = _unembed_flops(cfg, B, 1)
        out["total"] = sum(out.values())
        return out

    # ---- decode: one token per sequence -------------------------------
    Tc = T  # cache / context length
    if fam in ("dense", "moe"):
        attn = cfg.num_layers * _attn_layer_flops(cfg, B, 1, Tc)
        ffn = cfg.num_layers * (
            _moe_flops(cfg, B, 1, moe_group) if fam == "moe"
            else _mlp_flops(cfg, B, 1))
        out = {"attention": attn, "ffn": ffn}
    elif fam == "ssm":
        d = cfg.d_model
        di = cfg.ssm_expand * d
        H, P, S = di // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
        per = (2.0 * B * d * (2 * di + 2 * S + H) + 2.0 * B * di * d
               + 2.0 * B * H * P * S * 2)
        out = {"ssm": cfg.num_layers * per}
    elif fam == "hybrid":
        d = cfg.d_model
        di = cfg.ssm_expand * d
        H, P, S = di // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
        per = (2.0 * B * d * (2 * di + 2 * S + H) + 2.0 * B * di * d
               + 2.0 * B * H * P * S * 2)
        n_sites = cfg.num_layers // cfg.shared_attn_period
        out = {"ssm": cfg.num_layers * per,
               "attention": n_sites * (_attn_layer_flops(cfg, B, 1, Tc)
                                       + _mlp_flops(cfg, B, 1))}
    elif fam == "audio":
        out = {"decoder": cfg.num_layers * (
            _attn_layer_flops(cfg, B, 1, Tc)
            + _attn_layer_flops(cfg, B, 1, cfg.encoder_seq)
            + 2 * _mlp_flops(cfg, B, 1))}
    elif fam == "vlm":
        n_cross = cfg.num_layers // cfg.cross_attn_period
        n_self = cfg.num_layers - n_cross
        out = {"attention": n_self * (_attn_layer_flops(cfg, B, 1, Tc)
                                      + _mlp_flops(cfg, B, 1)),
               "cross": n_cross * (_attn_layer_flops(cfg, B, 1,
                                                     cfg.vision_seq)
                                   + _mlp_flops(cfg, B, 1))}
    out["unembed"] = _unembed_flops(cfg, B, 1)
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# HBM bytes.
# ---------------------------------------------------------------------------
def param_bytes(cfg: ArchConfig) -> float:
    return cfg.param_count() * BF16


def bytes_cell(cfg: ArchConfig, shape: InputShape) -> Dict[str, float]:
    """Global HBM traffic for one step (streaming lower bound)."""
    B, T = shape.global_batch, shape.seq_len
    N = B * T
    d = cfg.d_model
    pbytes = param_bytes(cfg)
    out: Dict[str, float] = {}

    if shape.kind == "train":
        # weights: fwd + remat recompute + bwd reads, grad write, adam rmw.
        out["weights"] = pbytes * 3
        out["grads+optimizer"] = (cfg.param_count()
                                  * (BF16 * 2 + F32 * 4 + F32 * 2))
        # layer-boundary activations saved + re-read (remat policy).
        out["activations"] = 2.0 * cfg.num_layers * N * d * BF16
        out["tokens"] = 2.0 * N * 4
    elif shape.kind == "prefill":
        out["weights"] = pbytes
        out["activations"] = 2.0 * cfg.num_layers * N * d * BF16
    else:  # decode
        active = pbytes
        if cfg.num_experts:
            # Dense-dispatch reads every expert's weights each step.
            active = pbytes
        out["weights"] = active
        if cfg.family in ("dense", "moe", "audio", "vlm"):
            sites = cfg.num_layers
            if cfg.family == "vlm":
                sites = cfg.num_layers - cfg.num_layers // cfg.cross_attn_period
            kv = 2.0 * sites * B * T * cfg.num_kv_heads * cfg.hd() * BF16
            out["kv_cache_read"] = kv
            out["kv_cache_write"] = kv / T
        if cfg.family in ("ssm", "hybrid"):
            di = cfg.ssm_expand * d
            H, P, S = di // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
            out["ssm_state_rmw"] = 2.0 * cfg.num_layers * B * H * P * S * F32
            if cfg.family == "hybrid":
                sites = cfg.num_layers // cfg.shared_attn_period
                kv = 2.0 * sites * B * T * cfg.num_kv_heads * cfg.hd() * BF16
                out["kv_cache_read"] = kv
    out["total"] = sum(out.values())
    return out


def summarize(cfg: ArchConfig, shape: InputShape, n_devices: int,
              moe_group: int = 256,
              train_factor: float = TRAIN_FACTOR) -> Dict[str, float]:
    f = flops_cell(cfg, shape, moe_group, train_factor)
    b = bytes_cell(cfg, shape)
    return {
        "flops_total": f["total"],
        "flops_per_device": f["total"] / n_devices,
        "bytes_total": b["total"],
        "bytes_per_device": b["total"] / n_devices,
        "flops_breakdown": f,
        "bytes_breakdown": b,
    }
