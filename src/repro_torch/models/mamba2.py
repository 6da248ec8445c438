"""Mamba-2 (SSD, arXiv:2405.21060): the part the decoder-only slice needs.

Port of `repro.models.mamba2`'s shape helpers: `_dims` and
`ssd_params_per_layer`, which `ArchConfig.params_count` calls for the ssm
family.  The model itself (the chunked SSD scan, its decode step and
cache) is not ported yet (ROADMAP queue 1); `models.api.get_model` raises
for the ssm family.

Shapes: d_inner = expand*d_model, H = d_inner/P heads, state N per head.
"""
from __future__ import annotations

__all__ = ["ssd_params_per_layer"]


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return d_inner, H, s.head_dim, s.state_dim


def ssd_params_per_layer(cfg) -> int:
    d = cfg.d_model
    d_inner, H, P, N = _dims(cfg)
    conv_dim = d_inner + 2 * N
    return (d * (2 * d_inner + 2 * N + H)      # in_proj (z, x, B, C, dt)
            + conv_dim * cfg.ssm.conv_width    # depthwise conv
            + 2 * H                            # A_log, D
            + H                                # dt bias
            + d_inner * d)                     # out_proj
