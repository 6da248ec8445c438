"""Unified model API: family dispatch for the serving entry points.

Port of `repro.models.api`.  The port serves the dense and moe families
(with the VLM prefix) through `models.transformer`; the ssm, hybrid and
encdec families are not ported yet (ROADMAP queue 1, item 1: mamba2.py,
rglru.py and encdec.py), and asking for them raises — there is no stand-in.
"""
from __future__ import annotations

import types

from . import transformer
from .config import ArchConfig

__all__ = ["get_model"]


def get_model(cfg: ArchConfig) -> types.ModuleType:
    """The module implementing cfg's family.  It exposes init_params(seed,
    cfg, device=...), forward(params, tokens, cfg, ...), init_cache,
    prefill(params, tokens, cfg, cache_len, ...) and decode_step(params,
    token, cache, pos, cfg)."""
    if cfg.family in ("dense", "moe"):
        return transformer
    if cfg.family in ("ssm", "hybrid", "encdec"):
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet: "
            f"ROADMAP queue 1 (mamba2.py, rglru.py, encdec.py)")
    raise KeyError(cfg.family)
