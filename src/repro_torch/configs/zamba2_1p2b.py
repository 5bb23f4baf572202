"""zamba2-1.2b [hybrid]: 38 Mamba2 layers + shared attention block
(arXiv:2411.15242).  38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64; the shared transformer block fires after every 6th SSM layer."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2_1p2b", family="hybrid", num_layers=38, d_model=2048,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, shared_attn_period=6,
    mlp_act="swiglu")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="zamba2_smoke", family="hybrid", num_layers=5, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, shared_attn_period=2,
        ssm_chunk=8, mlp_act="swiglu")
