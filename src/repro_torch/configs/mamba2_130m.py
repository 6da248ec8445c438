"""Mamba2-130M [arXiv:2405.21060; unverified]: 24L d_model=768 attn-free,
vocab=50280, ssm_state=128, SSD (state-space duality)."""
from ..models.config import ArchConfig, SSMConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
        n_heads=1, n_kv=1, d_ff=0, vocab=50280, attention="none",
        tie_embeddings=True,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=128))


def reduced() -> ArchConfig:
    return ArchConfig(
        name="mamba2-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=1, n_kv=1, d_ff=0, vocab=512, attention="none",
        tie_embeddings=True,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk=32),
        param_dtype="float32", activation_dtype="float32")
