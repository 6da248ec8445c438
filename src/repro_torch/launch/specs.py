"""Meta-device stand-ins for every (arch x input-shape) dry-run cell.

Port of `repro.launch.specs`: each spec is a tensor on the `meta` device
(shape and dtype, never allocated) where the reference has a
`jax.ShapeDtypeStruct`.

Shapes (assignment):
    train_4k      seq 4,096   global_batch 256   (train_step)
    prefill_32k   seq 32,768  global_batch 32    (serve prefill)
    decode_32k    seq 32,768  global_batch 128   (serve decode: 1 new token
                                                  against a seq-long cache)
    long_500k     seq 524,288 global_batch 1     (decode; SSM/hybrid only)

long_500k is SKIPPED for pure full-attention archs (DESIGN.md §4).
Encoder-decoder (seamless) runs decode shapes (it has a decoder).
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.config import ArchConfig

__all__ = ["SHAPES", "ShapeDef", "input_specs", "cell_is_applicable",
           "skip_reason"]


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeDef("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeDef("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeDef("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeDef("long_500k", 524288, 1, "decode"),
}


def cell_is_applicable(cfg: ArchConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.sub_quadratic
    return True


def skip_reason(cfg: ArchConfig, shape: str) -> str:
    if shape == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: 524k dense-decode KV window excluded "
                "by assignment (sub-quadratic archs only)")
    return ""


def f(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape_name) -> dict:
    """Returns {"kind", "batch"/"tokens"/..., per-kind structure}; a
    `ShapeDef` may stand for the shape's name."""
    sd = shape_name if isinstance(shape_name, ShapeDef) \
        else SHAPES[shape_name]
    B, S = sd.global_batch, sd.seq_len
    i32, f32 = torch.int32, torch.float32
    bf16 = torch.bfloat16
    d = cfg.d_model

    if sd.kind == "train":
        if cfg.family == "encdec":
            batch = {
                "src_embeds": f((B, S, d), f32),
                "tokens": f((B, S), i32),
                "labels": f((B, S), i32),
                "mask": f((B, S), f32),
            }
        elif cfg.frontend != "none":
            P = cfg.frontend_positions
            batch = {
                "prefix_embeds": f((B, P, d), f32),
                "tokens": f((B, S - P), i32),
                "labels": f((B, S - P), i32),
                "mask": f((B, S - P), f32),
            }
        else:
            batch = {"tokens": f((B, S), i32), "labels": f((B, S), i32),
                     "mask": f((B, S), f32)}
        return {"kind": "train", "batch": batch}

    if sd.kind == "prefill":
        out = {"kind": "prefill", "tokens": f((B, S), i32), "cache_len": S}
        if cfg.family == "encdec":
            out["src_embeds"] = f((B, S, d), f32)
        elif cfg.frontend != "none":
            P = cfg.frontend_positions
            out["tokens"] = f((B, S - P), i32)
            out["prefix_embeds"] = f((B, P, d), f32)
        return out

    # decode: one new token against a seq-long cache/state
    hd = cfg.resolved_head_dim
    out = {"kind": "decode", "token": f((B, 1), i32), "pos": S - 1,
           "cache_len": S}
    if cfg.family == "ssm":
        s = cfg.ssm
        d_inner = s.expand * d
        H = d_inner // s.head_dim
        conv_dim = d_inner + 2 * s.state_dim
        out["cache"] = {
            "conv": f((cfg.n_layers, B, s.conv_width - 1, conv_dim), bf16),
            "ssd": f((cfg.n_layers, B, H, s.head_dim, s.state_dim), f32),
        }
    elif cfg.family == "hybrid":
        from ..models.rglru import _pattern, _lru_width
        w = _lru_width(cfg)
        cache = []
        for kind in _pattern(cfg):
            if kind == "attn":
                win = min(S, cfg.window or S)
                cache.append({"k": f((B, win, cfg.n_kv, hd), bf16),
                              "v": f((B, win, cfg.n_kv, hd), bf16)})
            else:
                cache.append({"conv": f((B, 3, w), bf16),
                              "h": f((B, w), f32)})
        out["cache"] = cache
    elif cfg.family == "encdec":
        L = cfg.n_layers_decoder
        out["cache"] = {
            "k": f((L, B, S, cfg.n_kv, hd), bf16),
            "v": f((L, B, S, cfg.n_kv, hd), bf16),
            "xk": f((L, B, S, cfg.n_kv, hd), bf16),
            "xv": f((L, B, S, cfg.n_kv, hd), bf16),
        }
    else:
        L = cfg.n_layers
        out["cache"] = {
            "k": f((L, B, S, cfg.n_kv, hd), bf16),
            "v": f((L, B, S, cfg.n_kv, hd), bf16),
        }
    return out
