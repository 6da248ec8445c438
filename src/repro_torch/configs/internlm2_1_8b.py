"""InternLM2-1.8B [arXiv:2403.17297; hf]: 24L d_model=2048 16H (GQA kv=8)
d_ff=8192 vocab=92544."""
from ..models.config import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="internlm2-1.8b", family="dense", n_layers=24, d_model=2048,
        n_heads=16, n_kv=8, d_ff=8192, vocab=92544, rope_theta=1e6)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="internlm2-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, vocab=512, param_dtype="float32",
        activation_dtype="float32")
