"""Lower the assigned architecture configs to cost-model workloads.

Port of ``repro.costmodel.arch_workloads``: the same lowering, over the
port's own copy of the configs.  Every ArchConfig lowers to the per-layer
(CONV/GEMM) descriptor list the ConfuciuX Env consumes, so
``repro_torch.launch.search --arch qwen3-32b`` searches accelerator
resource assignments for serving that model.

Lowering conventions (per-layer GEMMs for one forward pass over ``tokens``
token positions):
  * attention: QKV / output projections as GEMMs; score and context batched
    GEMMs folded via ``repeat=heads``.
  * MoE: router GEMM + expert-bank GEMMs with M = tokens * top_k (the routed
    token-slots) and ``repeat=1`` per layer group -- each expert instance is
    one hardware partition in LP.
  * Mamba2/SSD: in/out projections + conv (as CONV descriptor) + the SSD
    intra-chunk matmuls as seq x seq GEMMs per chunk.
  * identical consecutive layers collapse into one entry with ``repeat=L``
    so RL episode lengths stay tractable for 90+ layer models (layers.py).
"""
from __future__ import annotations

from typing import List

from repro_torch import configs
from repro_torch.configs.base import ArchConfig
from repro_torch.costmodel.layers import LayerSpec


def _attn_layers(cfg: ArchConfig, tokens: int, ctx: int, repeat: int,
                 prefix: str) -> List[LayerSpec]:
    d, hd, H, Kv = cfg.d_model, cfg.hd(), cfg.num_heads, cfg.num_kv_heads
    return [
        LayerSpec.gemm(tokens, (H + 2 * Kv) * hd, d, repeat=repeat,
                       name=f"{prefix}.qkv"),
        LayerSpec.gemm(tokens, ctx, hd, repeat=repeat * H,
                       name=f"{prefix}.score"),
        LayerSpec.gemm(tokens, hd, ctx, repeat=repeat * H,
                       name=f"{prefix}.ctx"),
        LayerSpec.gemm(tokens, d, H * hd, repeat=repeat,
                       name=f"{prefix}.out"),
    ]


def _ffn_layers(cfg: ArchConfig, tokens: int, repeat: int,
                prefix: str) -> List[LayerSpec]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.num_experts:
        routed = tokens * cfg.experts_per_token
        out = [LayerSpec.gemm(tokens, cfg.num_experts, d, repeat=repeat,
                              name=f"{prefix}.router")]
        n_mats = 3 if cfg.mlp_act == "swiglu" else 2
        out.append(LayerSpec.gemm(routed, f * (n_mats - 1), d, repeat=repeat,
                                  name=f"{prefix}.experts_up"))
        out.append(LayerSpec.gemm(routed, d, f, repeat=repeat,
                                  name=f"{prefix}.experts_down"))
        return out
    if cfg.mlp_act == "swiglu":
        return [LayerSpec.gemm(tokens, 2 * f, d, repeat=repeat,
                               name=f"{prefix}.up_gate"),
                LayerSpec.gemm(tokens, d, f, repeat=repeat,
                               name=f"{prefix}.down")]
    return [LayerSpec.gemm(tokens, f, d, repeat=repeat,
                           name=f"{prefix}.up"),
            LayerSpec.gemm(tokens, d, f, repeat=repeat,
                           name=f"{prefix}.down")]


def _mamba_layers(cfg: ArchConfig, tokens: int, repeat: int,
                  prefix: str) -> List[LayerSpec]:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = di // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    S = cfg.ssm_state
    Q = min(cfg.ssm_chunk, tokens)
    nc = max(tokens // Q, 1)
    return [
        LayerSpec.gemm(tokens, 2 * di + 2 * S + H, d, repeat=repeat,
                       name=f"{prefix}.in_proj"),
        LayerSpec.conv(di + 2 * S, 1, tokens + 3, 1, 4, 1, repeat=repeat,
                       name=f"{prefix}.conv1d"),
        # SSD intra-chunk: (Q x Q) score and mix matmuls per chunk.
        LayerSpec.gemm(Q, Q, S, repeat=repeat * nc,
                       name=f"{prefix}.ssd_cb"),
        LayerSpec.gemm(Q, H * P, Q, repeat=repeat * nc,
                       name=f"{prefix}.ssd_mix"),
        LayerSpec.gemm(tokens, d, di, repeat=repeat,
                       name=f"{prefix}.out_proj"),
    ]


def lower_arch(name: str, tokens: int = 1024, ctx: int = None,
               include_unembed: bool = True) -> List[LayerSpec]:
    """Lower an architecture to its serving workload at ``tokens`` positions.

    ctx: attention context length (defaults to tokens -- self-attention over
    the processed window).
    """
    cfg = configs.get(name)
    ctx = ctx or tokens
    out: List[LayerSpec] = []
    fam = cfg.family
    L = cfg.num_layers
    if fam in ("dense", "moe"):
        out += _attn_layers(cfg, tokens, ctx, L, "blk")
        out += _ffn_layers(cfg, tokens, L, "blk")
    elif fam == "ssm":
        out += _mamba_layers(cfg, tokens, L, "blk")
    elif fam == "hybrid":
        sites = L // cfg.shared_attn_period
        out += _mamba_layers(cfg, tokens, L, "ssm")
        out += _attn_layers(cfg, tokens, ctx, sites, "shared")
        out += _ffn_layers(cfg, tokens, sites, "shared")
    elif fam == "audio":
        Se = cfg.encoder_seq
        out += _attn_layers(cfg, Se, Se, cfg.encoder_layers, "enc")
        out += _ffn_layers(cfg, Se, cfg.encoder_layers, "enc")
        out += _attn_layers(cfg, tokens, ctx, L, "dec.self")
        out += _attn_layers(cfg, tokens, Se, L, "dec.cross")
        out += _ffn_layers(cfg, tokens, L, "dec")
    elif fam == "vlm":
        n_cross = L // cfg.cross_attn_period
        n_self = L - n_cross
        out += _attn_layers(cfg, tokens, ctx, n_self, "self")
        out += _ffn_layers(cfg, tokens, n_self, "self")
        out += _attn_layers(cfg, tokens, cfg.vision_seq, n_cross, "cross")
        out += _ffn_layers(cfg, tokens, n_cross, "cross")
    else:
        raise ValueError(fam)
    if include_unembed:
        out.append(LayerSpec.gemm(tokens, cfg.vocab_size, cfg.d_model,
                                  name="unembed"))
    return out


def arch_names() -> List[str]:
    return list(configs.ARCH_IDS)
