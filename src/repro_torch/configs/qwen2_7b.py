"""Qwen2-7B [arXiv:2407.10671; hf]: 28L d_model=3584 28H (GQA kv=4)
d_ff=18944 vocab=152064, QKV bias."""
from ..models.config import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-7b", family="dense", n_layers=28, d_model=3584,
        n_heads=28, n_kv=4, d_ff=18944, vocab=152064, qkv_bias=True,
        rope_theta=1e6)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen2-smoke", family="dense", n_layers=2, d_model=56,
        n_heads=7, n_kv=1, d_ff=128, vocab=512, qkv_bias=True,
        param_dtype="float32", activation_dtype="float32")
