"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]:
48L d_model=5120 40H (GQA kv=8) vocab=202048; MoE 16 experts top-1 with
d_ff_expert=8192 + shared expert (d_ff=8192)."""
from ..models.config import ArchConfig, MoEConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="llama4-scout-17b-a16e", family="moe", n_layers=48,
        d_model=5120, n_heads=40, n_kv=8, d_ff=8192, vocab=202048,
        rope_theta=500000.0, remat_group=8,
        moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192,
                      shared_expert=True))


def reduced() -> ArchConfig:
    return ArchConfig(
        name="llama4-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=96, vocab=512,
        moe=MoEConfig(num_experts=4, top_k=1, d_ff_expert=96,
                      shared_expert=True),
        param_dtype="float32", activation_dtype="float32")
