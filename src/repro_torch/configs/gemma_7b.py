"""Gemma-7B [arXiv:2403.08295; hf]: 28L d_model=3072 16H (kv=16) d_ff=24576
GeGLU, head_dim=256, vocab 256000, tied embeddings."""
from ..models.config import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="gemma-7b", family="dense", n_layers=28, d_model=3072,
        n_heads=16, n_kv=16, d_ff=24576, vocab=256000, head_dim=256,
        act="gelu", tie_embeddings=True)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="gemma-7b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv=4, d_ff=128, vocab=512, head_dim=32, act="gelu",
        tie_embeddings=True, param_dtype="float32",
        activation_dtype="float32")
