"""InternVL2-1B — InternViT frontend (STUB) + InternLM2-chat-1.8b-ish 0.5B
text backbone [arXiv:2404.16821; hf].  Backbone per assignment: 24L
d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655; patch embeddings arrive
precomputed (frontend_positions=256)."""
from ..models.config import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-1b", family="dense", n_layers=24, d_model=896,
        n_heads=14, n_kv=2, d_ff=4864, vocab=151655, rope_theta=1e6,
        act="silu", frontend="vlm", frontend_positions=256,
        tie_embeddings=True)


def reduced() -> ArchConfig:
    return ArchConfig(
        name="internvl2-1b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, vocab=512, frontend="vlm",
        frontend_positions=8, tie_embeddings=True, param_dtype="float32",
        activation_dtype="float32")
