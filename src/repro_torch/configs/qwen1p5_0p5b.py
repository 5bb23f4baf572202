"""qwen1.5-0.5b [dense]: QKV bias (hf:Qwen/Qwen1.5-0.5B).
24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1p5_0p5b", family="dense", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, d_ff=2816, vocab_size=151936,
    qkv_bias=True, mlp_act="swiglu")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen1p5_smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
        qkv_bias=True, mlp_act="swiglu")
