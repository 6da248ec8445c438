"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]:
24L d_model=1024 16H (GQA kv=8) vocab=49155; MoE 32 experts top-8,
d_ff_expert=512."""
from ..models.config import ArchConfig, MoEConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
        n_heads=16, n_kv=8, d_ff=512, vocab=49155, tie_embeddings=True,
        moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512))


def reduced() -> ArchConfig:
    return ArchConfig(
        name="granite-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=64, vocab=512, tie_embeddings=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64),
        param_dtype="float32", activation_dtype="float32")
