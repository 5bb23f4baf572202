"""phi3.5-moe-42b-a6.6b [moe]: 16 experts top-2
(hf:microsoft/Phi-3.5-MoE-instruct).  32L d_model=4096 32H (kv=8)
d_ff=6400/expert vocab=32064."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3p5_moe_42b", family="moe", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=6400, vocab_size=32064,
    num_experts=16, experts_per_token=2, mlp_act="swiglu")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="phi3p5_moe_smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=256,
        num_experts=4, experts_per_token=2, mlp_act="swiglu")
