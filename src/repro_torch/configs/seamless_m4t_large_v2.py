"""SeamlessM4T-large-v2 backbone [arXiv:2308.11596; hf]: enc-dec, 24L
encoder + 24L decoder, d_model=1024 16H (kv=16) d_ff=8192 vocab=256206.
Audio frontend is a STUB: input_specs supplies precomputed frame
embeddings."""
from ..models.config import ArchConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-large-v2", family="encdec", n_layers=24,
        n_layers_decoder=24, d_model=1024, n_heads=16, n_kv=16, d_ff=8192,
        vocab=256206, frontend="audio", act="gelu")


def reduced() -> ArchConfig:
    return ArchConfig(
        name="seamless-smoke", family="encdec", n_layers=2,
        n_layers_decoder=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
        vocab=512, frontend="audio", act="gelu", param_dtype="float32",
        activation_dtype="float32")
