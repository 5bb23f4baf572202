"""mamba2-130m [ssm]: SSD, attention-free (arXiv:2405.21060).
24L d_model=768 ssm_state=128 vocab=50280; d_inner=1536, head_dim=64 -> 24
SSD heads."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2_130m", family="ssm", num_layers=24, d_model=768,
    num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, tie_embeddings=True)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mamba2_smoke", family="ssm", num_layers=3, d_model=64,
        num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=256,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=8,
        tie_embeddings=True)
