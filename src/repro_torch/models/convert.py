"""The reference's parameters carried into the port's modules.

`from_reference_params(cfg, params)` takes the params pytree of the
reference family's `init_params` as numpy arrays (nested dicts, lists and
tuples; the caller converts with `np.asarray`) and returns the port's
model for that family (`Transformer`, `Mamba2`, `RecurrentGemma`,
`EncDec`) holding the same numbers, so that tests run the same model
through both packages.  The module's parameter names are the reference's
paths with the layer index put in ("blocks.3.attn.q.w" for
`params["blocks"]["attn"]["q"]["w"][3]`):
  * dense, moe, ssm: the blocks, stacked on a leading (n_layers,) axis
    (always for ssm; for the others when the config scans its layers),
    are unstacked; a list of per-layer dicts is taken as it is;
  * hybrid: the reference stacks each pattern position p's layers into
    `groups[p]` (a leading (G,) axis) and keeps the remainder in the list
    `tail`; group p's slice g is layer g * len(pattern) + p ("layers.i"),
    tail entry i is layer G * len(pattern) + i;
  * encdec: `enc` and `dec`, stacked or lists as the blocks above;
  * dense weights keep the reference's (d_in, d_out) orientation (no
    transpose); the MoE stacks keep (E, d, dff) and (E, dff, d); biases
    (`qkv_bias`) and the shared expert carry across by name;
  * a tied model has no "unembed" (its logits read the embedding table).
A missing or unexpected key, or a shape that differs, raises ValueError.
Bfloat16 arrays (ml_dtypes) pass through float32, which holds them
exactly.

`named_arrays(cfg, tree)` is the same mapping for any params-shaped
reference tree (gradients, AdamW's m and v): {port name: numpy array}.
`from_reference_state(cfg, state)` carries a reference train state
{"params", "opt": {"m", "v", "step"}} into the port's (the model with its
gradients on, and name-keyed float32 m and v, as `train.init_state`
builds it).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .api import get_model
from .rglru import _group_split

__all__ = ["from_reference_params", "reference_shapes", "named_arrays",
           "from_reference_state"]


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for k, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _layers(prefix: str, tree, n: int, index=lambda j: j):
    """(port name, leaf, row or None) for a tree of layers: a list of
    per-layer dicts, or one dict stacked on a leading (n,) axis whose row
    j is layer `index(j)`."""
    if isinstance(tree, (list, tuple)):
        for j, bp in enumerate(tree):
            for name, leaf in _flatten(bp):
                yield f"{prefix}.{index(j)}.{name}", leaf, None
        return
    for name, leaf in _flatten(tree):
        if leaf.shape[:1] != (n,):
            raise ValueError(f"stacked {prefix} leaf {name!r} has shape "
                             f"{tuple(leaf.shape)}, not ({n}, ...)")
        for j in range(n):
            yield f"{prefix}.{index(j)}.{name}", leaf, j


def _leaves(cfg, params):
    """(port name, leaf, row or None) for every reference leaf; a stacked
    leaf comes once per layer, with the row that holds it."""
    stacks = {"blocks": cfg.n_layers, "enc": cfg.n_layers,
              "dec": cfg.n_layers_decoder}
    for key, tree in params.items():
        if key == "groups" and cfg.family == "hybrid":
            plen = len(cfg.recurrent.pattern)
            G, _ = _group_split(cfg)
            for p, group in enumerate(tree):
                yield from _layers("layers", group, G,
                                   lambda g, p=p: g * plen + p)
        elif key == "tail" and cfg.family == "hybrid":
            base = _group_split(cfg)[0] * len(cfg.recurrent.pattern)
            yield from _layers("layers", list(tree), 0,
                               lambda i: base + i)
        elif key in stacks:
            yield from _layers(key, tree, stacks[key])
        else:
            for name, leaf in _flatten({key: tree}):
                yield name, leaf, None


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


def from_reference_params(cfg, params, *, device=None):
    """The port's model of `cfg`'s family holding the reference params'
    numbers, on `device` (the card unless device="cpu")."""
    dev = resolve_device(device)
    model = get_model(cfg).MODEL(cfg, device=dev)      # uninitialized
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


def named_arrays(cfg, tree) -> dict:
    """{port parameter name: numpy array} of a params-shaped reference
    tree: a stacked leaf gives one array a layer."""
    return {name: np.asarray(leaf if i is None else np.asarray(leaf)[i])
            for name, leaf, i in _leaves(cfg, tree)}


def from_reference_state(cfg, state, *, device=None) -> dict:
    """The port's train state holding a reference train state's numbers:
    {"params": the model (gradients on), "opt": {"m", "v": {name: float32
    tensor}, "step": int32 tensor}} on `device` (the card unless
    device="cpu")."""
    model = from_reference_params(cfg, state["params"], device=device)
    model.requires_grad_(True)
    dev = model.device
    opt = state["opt"]

    def moments(tree):
        return {k: torch.from_numpy(np.array(a, np.float32)).to(dev)
                for k, a in named_arrays(cfg, tree).items()}
    return {"params": model,
            "opt": {"m": moments(opt["m"]), "v": moments(opt["v"]),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32, device=dev)}}
