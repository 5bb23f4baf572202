"""qwen2.5-3b [dense]: GQA, QKV bias (hf:Qwen/Qwen2.5 family).
36L d_model=2048 16H (kv=2) d_ff=11008 vocab=151936."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2p5_3b", family="dense", num_layers=36, d_model=2048,
    num_heads=16, num_kv_heads=2, d_ff=11008, vocab_size=151936,
    qkv_bias=True, mlp_act="swiglu")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen2p5_smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
        qkv_bias=True, mlp_act="swiglu")
