"""Unified model API: family dispatch for the serving entry points.

Port of `repro.models.api`: the dense and moe families (with the VLM
prefix) through `models.transformer`, ssm through `models.mamba2`, hybrid
through `models.rglru`, encdec through `models.encdec`.
"""
from __future__ import annotations

import types

from . import encdec, mamba2, rglru, transformer
from .config import ArchConfig

__all__ = ["get_model"]


def get_model(cfg: ArchConfig) -> types.ModuleType:
    """The module implementing cfg's family.  It exposes MODEL (the
    model class, built as MODEL(cfg, device=...)), init_params(seed, cfg,
    device=...), forward(params, tokens, cfg, ...) (encdec's takes the
    source embeddings first), prefill(params, tokens, cfg, cache_len, ...)
    and decode_step(params, token, cache, pos, cfg); init_cache (init_state
    for ssm) sizes the cache."""
    if cfg.family in ("dense", "moe"):
        return transformer
    if cfg.family == "ssm":
        return mamba2
    if cfg.family == "hybrid":
        return rglru
    if cfg.family == "encdec":
        return encdec
    raise KeyError(cfg.family)
