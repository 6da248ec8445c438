"""Llama-3-8B [arXiv:2407.21783; unverified]: 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256."""
from ..models.config import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="llama3-8b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv=8, d_ff=14336, vocab=128256, rope_theta=500000.0)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="llama3-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=8, n_kv=2, d_ff=160, vocab=512, param_dtype="float32",
        activation_dtype="float32")
