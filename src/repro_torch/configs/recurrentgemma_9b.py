"""RecurrentGemma-9B [arXiv:2402.19427; unverified]: 38L d_model=4096
16H (MQA kv=1) d_ff=12288 vocab=256000; RG-LRU + local attention (window
2048), pattern rec,rec,attn (1:2)."""
from ..models.config import ArchConfig, RecurrentConfig


def get_config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b", family="hybrid", n_layers=38,
        d_model=4096, n_heads=16, n_kv=1, d_ff=12288, vocab=256000,
        head_dim=256, act="gelu", attention="local", window=2048,
        tie_embeddings=True, scan_layers=False,
        recurrent=RecurrentConfig(lru_width=4096, window=2048))


def reduced() -> ArchConfig:
    return ArchConfig(
        name="rgemma-smoke", family="hybrid", n_layers=3, d_model=64,
        n_heads=4, n_kv=1, d_ff=128, vocab=512, head_dim=16, act="gelu",
        attention="local", window=16, tie_embeddings=True,
        scan_layers=False, recurrent=RecurrentConfig(lru_width=64, window=16),
        param_dtype="float32", activation_dtype="float32")
