"""qwen3-32b [dense]: qk_norm, GQA (hf:Qwen/Qwen3 family).
64L d_model=5120 64H (kv=8) d_ff=25600 vocab=151936, head_dim=128."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_32b", family="dense", num_layers=64, d_model=5120,
    num_heads=64, num_kv_heads=8, d_ff=25600, vocab_size=151936,
    head_dim=128, qk_norm=True, mlp_act="swiglu")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen3_smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        qk_norm=True, mlp_act="swiglu")
