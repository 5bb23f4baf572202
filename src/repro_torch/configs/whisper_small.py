"""whisper-small [audio]: enc-dec, conv frontend stubbed (arXiv:2212.04356).
12L decoder + 12L encoder, d_model=768 12H (kv=12) d_ff=3072 vocab=51865;
encoder consumes precomputed 1500-frame embeddings (input_specs stub)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper_small", family="audio", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=51865,
    encoder_layers=12, encoder_seq=1500, mlp_act="gelu")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="whisper_smoke", family="audio", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
        encoder_layers=2, encoder_seq=32, mlp_act="gelu")
