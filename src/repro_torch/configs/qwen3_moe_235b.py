"""qwen3-moe-235b-a22b [moe]: 128 experts top-8 (hf:Qwen/Qwen3-30B-A3B
family).  94L d_model=4096 64H (kv=4) d_ff=1536/expert vocab=151936,
head_dim=128, qk_norm."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_moe_235b", family="moe", num_layers=94, d_model=4096,
    num_heads=64, num_kv_heads=4, d_ff=1536, vocab_size=151936,
    head_dim=128, qk_norm=True, num_experts=128, experts_per_token=8,
    mlp_act="swiglu")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen3_moe_smoke", family="moe", num_layers=3, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=32, vocab_size=256, head_dim=16,
        qk_norm=True, num_experts=8, experts_per_token=2, mlp_act="swiglu")
