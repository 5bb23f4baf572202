"""llama-3.2-vision-90b [vlm]: cross-attn image layers
(hf:meta-llama/Llama-3.2-Vision family).  100L d_model=8192 64H (kv=8)
d_ff=28672 vocab=128256; every 5th layer cross-attends to precomputed patch
embeddings (vision tower stubbed per the brief)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3p2_vision_90b", family="vlm", num_layers=100, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=28672, vocab_size=128256,
    head_dim=128, cross_attn_period=5, vision_seq=1601, mlp_act="swiglu")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llama_vision_smoke", family="vlm", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        cross_attn_period=2, vision_seq=16, mlp_act="swiglu")
