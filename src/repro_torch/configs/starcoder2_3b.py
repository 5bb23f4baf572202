"""starcoder2-3b [dense]: GQA, RoPE, GELU MLP (arXiv:2402.19173).
30L d_model=3072 24H (kv=2) d_ff=12288 vocab=49152."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2_3b", family="dense", num_layers=30, d_model=3072,
    num_heads=24, num_kv_heads=2, d_ff=12288, vocab_size=49152,
    mlp_act="gelu")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="starcoder2_smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
        mlp_act="gelu")
