"""The reference's parameters carried into the port's modules.

`from_reference_params(cfg, params)` takes the params pytree of
`repro.models.transformer.init_params` as numpy arrays (nested dicts; the
caller converts with `np.asarray`) and returns the port's `Transformer`
holding the same numbers, so that tests run the same model through both
packages.  The module's parameter names are the reference's paths
("blocks.3.attn.q.w" for `params["blocks"]["attn"]["q"]["w"][3]`):
  * the blocks, stacked on a leading (n_layers,) axis when the config
    scans its layers (`scan_layers=True`), are unstacked; a list of
    per-layer dicts is taken as it is;
  * dense weights keep the reference's (d_in, d_out) orientation (no
    transpose); the MoE stacks keep (E, d, dff) and (E, dff, d); biases
    (`qkv_bias`) and the shared expert carry across by name;
  * a tied model has no "unembed" (its logits read the embedding table).
A missing or unexpected key, or a shape that differs, raises ValueError.
Bfloat16 arrays (ml_dtypes) pass through float32, which holds them
exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .transformer import Transformer

__all__ = ["from_reference_params", "reference_shapes"]


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _leaves(cfg, params):
    """(port name, leaf, layer index or None) for every reference leaf; a
    stacked block leaf comes once per layer."""
    for name, leaf in _flatten({k: v for k, v in params.items()
                                if k != "blocks"}):
        yield name, leaf, None
    blocks = params.get("blocks")
    if blocks is None:
        return
    if isinstance(blocks, (list, tuple)):
        for i, bp in enumerate(blocks):
            for name, leaf in _flatten(bp):
                yield f"blocks.{i}.{name}", leaf, None
        return
    for name, leaf in _flatten(blocks):
        if leaf.shape[:1] != (cfg.n_layers,):
            raise ValueError(f"stacked block leaf {name!r} has shape "
                             f"{tuple(leaf.shape)}, not ({cfg.n_layers}, "
                             f"...)")
        for i in range(cfg.n_layers):
            yield f"blocks.{i}.{name}", leaf, i


def reference_shapes(cfg, params) -> dict:
    """{port parameter name: shape} of a reference params tree (arrays, or
    `jax.eval_shape`'s shape structs: anything with `.shape`)."""
    return {name: tuple(leaf.shape[1:] if i is not None else leaf.shape)
            for name, leaf, i in _leaves(cfg, params)}


def _tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def from_reference_params(cfg, params, *, device=None) -> Transformer:
    """The port's `Transformer` for `cfg` holding the reference params'
    numbers, on `device` (the card unless device="cpu")."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)             # uninitialized
    ours = dict(model.named_parameters())
    shapes = reference_shapes(cfg, params)
    missing = sorted(set(ours) - set(shapes))
    unexpected = sorted(set(shapes) - set(ours))
    if missing or unexpected:
        raise ValueError(f"reference params do not match {cfg.name}: "
                         f"missing {missing}, unexpected {unexpected}")
    bad = [(k, shapes[k], tuple(p.shape)) for k, p in ours.items()
           if shapes[k] != tuple(p.shape)]
    if bad:
        raise ValueError(f"reference params do not match {cfg.name}: "
                         f"shapes (reference, port) {bad}")
    with torch.no_grad():
        for name, leaf, i in _leaves(cfg, params):
            src = _tensor(leaf if i is None else np.asarray(leaf)[i])
            ours[name].copy_(src)
    return model
