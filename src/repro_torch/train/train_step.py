"""The train step and the serving pair, for every family, on one device
or on a mesh.

Port of `repro.train.train_step`: `make_train_step` is loss -> gradients
-> AdamW, with optional microbatch gradient accumulation (float32
gradients summed over slices of the batch, then the loss and the
gradients averaged, as the reference's scan does) and the optional int8
error-feedback compression of the gradient mean over the pod group
(`compression.compressed_psum_tree`, when the state holds "residuals").

A state is {"params": the family's model with its gradients on, "opt":
{"m", "v": {name: float32 tensor}, "step": int32 tensor}} (+ "residuals":
{name: float32 tensor}); `train_step(state, batch)` updates it in place
and returns (state, metrics), metrics {"loss", "grad_norm", "lr"} as
float32 tensors on the model's device.  A batch is the data pipeline's
dict of numpy arrays or tensors; token ids become int64 on the device.

On a mesh (a `DeviceMesh` with the axes "data" and "model", and "pod"
before them on the multi-pod mesh) the reference's pjit placements are
DTensor placements.  `place_state` turns the parameters, m, v and the
residuals into DTensors placed by the plan (`state_shardings`:
`sharding.param_placements`; the step stays a plain tensor, the same on
every rank), so each rank holds only its shards.  A step on a placed
state keeps each rank's part of the global batch (`place_batch`, by
`batch_shardings`: dim 0 over the batch axes when they divide it), runs
the loss and its gradients on DTensors under the model's anchors
(`meshctx`; the caller sets the mesh context), and redistributes each
gradient to its parameter's placements: the gradient mean over the
data-parallel ranks is the one the placements imply (a reduce-scatter
over "data" for an FSDP shard, an all-reduce for a replicated leaf).
`compress_pod` then runs the int8 EF mean over the "pod" axis, on the
gradients as the reference's pjit step holds them (already reduced over
every data-parallel axis).  AdamW runs on the shards (`optimizer`).  The
metrics are plain replicated tensors.
"""
from __future__ import annotations

import functools
import math
from typing import Callable

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from ..models.api import get_model
from ..models.common import on_device
from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .sharding import batch_specs, param_placements

__all__ = ["make_train_step", "make_serve_fns", "TrainState", "init_state",
           "state_shardings", "batch_shardings", "place_state",
           "place_batch", "value_and_grad", "to_device", "placed"]

TrainState = dict  # {"params": ..., "opt": ..., "residuals": optional}

_INTS = ("tokens", "labels")


def init_state(seed, cfg, opt_cfg: AdamWConfig | None = None, *,
               device=None) -> dict:
    """The family's model drawn from `seed` on `device` (the card unless
    device="cpu"; without a card the default raises), its gradients on,
    and AdamW's zero state."""
    model = get_model(cfg).init_params(seed, cfg, device=device)
    model.requires_grad_(True)
    return {"params": model, "opt": init_opt_state(model)}


def state_shardings(state_shape, mesh) -> dict:
    """The placements of a train state on `mesh` (a `DeviceMesh`): the
    params, m, v and residuals each take the params' placements by the
    plan, and the step is replicated.  `state_shape` is a state, or any
    dict whose "params" is a module or {name: tensor or shape}."""
    pl = param_placements(state_shape["params"], mesh)
    out = {"params": pl,
           "opt": {"m": pl, "v": pl,
                   "step": (Replicate(),) * mesh.ndim}}
    if "residuals" in state_shape:
        out["residuals"] = pl
    return out


def batch_shardings(batch_shape, mesh) -> dict:
    """{key: placements} of a batch on `mesh`: dimension 0 over the batch
    axes ("pod", "data") or ("data",), replicated when their size does
    not divide it."""
    axes = batch_specs(mesh)
    names = list(mesh.mesh_dim_names)
    sz = math.prod(mesh.size(names.index(a)) for a in axes)

    def one(leaf):
        n = getattr(leaf, "shape", leaf)[0]
        return tuple(Shard(0) if name in axes and n % sz == 0
                     else Replicate() for name in names)
    return {k: one(v) for k, v in batch_shape.items()}


def place_batch(batch: dict, mesh) -> dict:
    """The global batch (every rank holds all of it: the data pipeline
    draws it from the same seed) as DTensors placed by `batch_shardings`:
    each rank keeps its own rows, nothing moves between ranks."""
    out = {}
    for k, pl in batch_shardings(batch, mesh).items():
        t = batch[k]
        if isinstance(t, DTensor):
            out[k] = t
            continue
        rows, start = t.shape[0], 0
        for dim, p in enumerate(pl):
            if p == Shard(0):
                rows //= mesh.size(dim)
                start = start * mesh.size(dim) + mesh.get_local_rank(dim)
        out[k] = DTensor.from_local(t[start * rows:(start + 1) * rows],
                                    mesh, pl, run_check=False,
                                    shape=t.shape, stride=t.stride())
    return out


def placed(state) -> bool:
    """Whether the state's parameters are DTensors (`place_state`)."""
    return any(isinstance(p, DTensor)
               for p in state["params"].parameters())


def place_state(state: dict, mesh) -> dict:
    """The state's parameters, m, v and residuals turned into DTensors on
    `mesh` by the plan (`state_shardings`), in place: each rank keeps only
    its shards (its local blocks of the tensors it held whole; every rank
    holds the same numbers, drawn from the same seed).  Returns the
    state."""
    pl = state_shardings(state, mesh)
    model = state["params"]
    for mod_name, mod in model.named_modules():
        for pn, p in list(mod._parameters.items()):
            if p is None or isinstance(p, DTensor):
                continue
            name = f"{mod_name}.{pn}" if mod_name else pn
            mod._parameters[pn] = nn.Parameter(
                _local(p.detach(), mesh, pl["params"][name]),
                requires_grad=p.requires_grad)

    def place(d, pls):
        return {k: t if isinstance(t, DTensor) else _local(t, mesh, pls[k])
                for k, t in d.items()}
    state["opt"]["m"] = place(state["opt"]["m"], pl["opt"]["m"])
    state["opt"]["v"] = place(state["opt"]["v"], pl["opt"]["v"])
    if "residuals" in state:
        state["residuals"] = place(state["residuals"], pl["residuals"])
    return state


def _local(t: torch.Tensor, mesh, placements) -> DTensor:
    """The DTensor whose local block this rank cuts from the whole tensor
    t that it holds (no collective: every rank holds the same t)."""
    d = distribute_tensor(t, mesh, placements, src_data_rank=None)
    # a copy of the block, so that the whole tensor's storage is freed
    return DTensor.from_local(d.to_local().clone(), mesh, d.placements,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


def to_device(batch: dict, device) -> dict:
    """The batch's arrays on `device`: token ids int64, the rest float32."""
    return {k: on_device(v, device).long() if k in _INTS
            else on_device(v, device).float() for k, v in batch.items()}


def value_and_grad(params, batch: dict, loss_fn: Callable):
    """(loss, {name: gradient}) of `loss_fn(params, batch)`; a parameter
    the loss does not reach gets None.  On DTensors, plain tensors that
    the model makes (positions, masks, zeros) count as replicated, in the
    forward and in the backward's recomputations."""
    with implicit_replication():
        return _value_and_grad(params, batch, loss_fn)


def _value_and_grad(params, batch, loss_fn):
    named = [(n, p) for n, p in params.named_parameters() if p.requires_grad]
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return loss.detach(), {n: g for (n, _), g in zip(named, grads)}


def make_train_step(cfg, opt_cfg: AdamWConfig, *, microbatch: int = 1,
                    compress_pod: bool = False) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    microbatch: number of gradient-accumulation slices (must divide the
    global batch).  compress_pod: int8 EF compression of the gradient
    mean over the default process group (requires state["residuals"])."""
    model = get_model(cfg)
    loss_fn = functools.partial(model.loss_fn, cfg=cfg)

    def grads_of(params, batch):
        loss, grads = value_and_grad(params, batch, loss_fn)
        return loss, {n: torch.zeros_like(p) if grads[n] is None
                      else grads[n]
                      for n, p in params.named_parameters() if n in grads}

    def compute_grads(params, batch, put):
        if microbatch <= 1:
            return grads_of(params, put(batch))
        B = next(iter(batch.values())).shape[0]
        if B % microbatch:
            raise ValueError(f"microbatch {microbatch} does not divide the "
                             f"batch of {B}")
        mb = B // microbatch
        loss_acc, g_acc = None, None
        for i in range(microbatch):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            l, g = grads_of(params, put(part))
            if g_acc is None:
                loss_acc = l
                g_acc = {k: t.float() for k, t in g.items()}
            else:
                loss_acc = loss_acc + l
                for k, t in g.items():
                    g_acc[k] += t.float()
        inv = 1.0 / microbatch
        return loss_acc * inv, {k: t * inv for k, t in g_acc.items()}

    def train_step(state, batch):
        params = state["params"]
        batch = to_device(batch, params.device)
        mesh = params.embed.w.device_mesh if placed(state) else None

        def put(b):
            return b if mesh is None else place_batch(b, mesh)
        loss, grads = compute_grads(params, batch, put)
        if mesh is not None:
            # the gradient mean the placements imply: each gradient (a
            # partial sum over the ranks that hold other rows of the
            # batch) reduced to its parameter's placements
            pl = dict(params.named_parameters())
            grads = {k: g.redistribute(mesh, pl[k].placements)
                     for k, g in grads.items()}
        if compress_pod and "residuals" in state:
            from .compression import compressed_psum_tree
            grads, state["residuals"] = compressed_psum_tree(
                grads, state["residuals"], mesh=mesh)
        _, state["opt"], stats = adamw_update(opt_cfg, params, grads,
                                              state["opt"])
        metrics = {"loss": loss, **stats}
        return state, {k: _replicated(v) for k, v in metrics.items()}

    return train_step


def _replicated(t):
    """A metric as a plain tensor: a DTensor's value, reduced and
    replicated, on every rank."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh,
                          (Replicate(),) * t.device_mesh.ndim).to_local()


def make_serve_fns(cfg):
    """(prefill_fn, decode_fn) for the arch family."""
    model = get_model(cfg)

    def prefill_fn(params, tokens, cache_len, **kw):
        return model.prefill(params, tokens, cfg, cache_len=cache_len, **kw)

    def decode_fn(params, token, cache, pos):
        return model.decode_step(params, token, cache, pos, cfg)

    return prefill_fn, decode_fn
