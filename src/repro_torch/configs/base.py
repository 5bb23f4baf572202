"""Architecture config schema + registry of the PyTorch port.

A copy of the JAX package's ``configs/base.py`` (the port imports nothing
of it).  One file per assigned architecture lives in this package, all
ten of them; each exposes ``CONFIG`` (the exact published shape) and
``smoke()`` (a reduced same-family config for CPU tests).  ``get`` and
``get_smoke`` look either up; an unknown id raises ``ValueError``.  The
LM decodes and serves every family (``models.lm``), and every family
lowers to a search workload (``costmodel.arch_workloads``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # Attention details.
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0

    # MoE (d_ff above is the per-expert hidden dim when num_experts > 0).
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD).
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128

    # Hybrid (zamba2): one *shared* attention block invoked every
    # ``shared_attn_period`` SSM layers.
    shared_attn_period: int = 0

    # Encoder-decoder (whisper): ``num_layers`` is the decoder depth.
    encoder_layers: int = 0
    encoder_seq: int = 1500     # whisper-small: 30 s -> 1500 frames

    # VLM: one cross-attention layer every ``cross_attn_period`` layers
    # (counted within num_layers) attending to ``vision_seq`` patch embeds.
    cross_attn_period: int = 0
    vision_seq: int = 1601      # (448/14)^2 + cls for Llama-3.2-Vision

    mlp_act: str = "swiglu"     # swiglu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # Numerics.
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True iff decode cost/state is sub-linear in context (SSM/hybrid).

        Pure full-attention archs skip the long_500k shape (DESIGN.md
        SArch-applicability)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, hd = self.d_model, self.d_ff, self.hd()
        qkv = d * hd * (self.num_heads + 2 * self.num_kv_heads) + hd * \
            self.num_heads * d
        if self.mlp_act == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.num_experts:
            mlp = self.num_experts * 3 * d * f + d * self.num_experts
        if self.family == "ssm":
            di = self.ssm_expand * d
            blk = d * (2 * di + 2 * self.ssm_state) + di * d
        elif self.family == "hybrid":
            di = self.ssm_expand * d
            blk = d * (2 * di + 2 * self.ssm_state) + di * d + mlp // 4
        else:
            blk = qkv + mlp
        n = self.num_layers * blk + 2 * self.vocab_size * d
        if self.encoder_layers:
            n += self.encoder_layers * (qkv + mlp)
        return int(n)



# Input shape grid (the reference's per-architecture shape set).
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES: Tuple[InputShape, ...] = (
    InputShape("train_4k", 4096, 256, "train"),
    InputShape("prefill_32k", 32768, 32, "prefill"),
    InputShape("decode_32k", 32768, 128, "decode"),
    InputShape("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> InputShape:
    """The shape called ``name``; an unknown name raises ``KeyError``."""
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)

ARCH_IDS: List[str] = [
    "zamba2_1p2b",
    "phi3p5_moe_42b",
    "qwen3_moe_235b",
    "whisper_small",
    "qwen3_32b",
    "qwen1p5_0p5b",
    "starcoder2_3b",
    "qwen2p5_3b",
    "mamba2_130m",
    "llama3p2_vision_90b",
]

# CLI-friendly aliases (the brief's ids).
ALIASES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "phi3.5-moe-42b-a6.6b": "phi3p5_moe_42b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "whisper-small": "whisper_small",
    "qwen3-32b": "qwen3_32b",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen2.5-3b": "qwen2p5_3b",
    "mamba2-130m": "mamba2_130m",
    "llama-3.2-vision-90b": "llama3p2_vision_90b",
}


def canonical(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def _module(name: str):
    arch = canonical(name)
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; one of "
                         f"{', '.join(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).smoke()


def all_configs() -> List[ArchConfig]:
    return [get(a) for a in ARCH_IDS]
