"""RecurrentGemma-style hybrid (RG-LRU + local attention, arXiv:2402.19427):
the part the decoder-only slice needs.

Port of `repro.models.rglru`'s layer-pattern helpers, `_lru_width` and
`_pattern`, which `launch.specs.input_specs` reads for the hybrid
family's decode cache.  The model itself (the RG-LRU scan, its blocks and
cache) is not ported yet (ROADMAP queue 1); `models.api.get_model` raises
for the hybrid family.
"""
from __future__ import annotations

__all__ = []


def _lru_width(cfg):
    return cfg.recurrent.lru_width or cfg.d_model


def _pattern(cfg):
    pat = cfg.recurrent.pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]
