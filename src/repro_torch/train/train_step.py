"""The train step and the serving pair, for every family.

Port of `repro.train.train_step` on one device: `make_train_step` is loss
-> gradients -> AdamW, with optional microbatch gradient accumulation
(float32 gradients summed over slices of the batch, then the loss and the
gradients averaged, as the reference's scan does) and the optional int8
error-feedback compression of the gradient mean over the default process
group (`compression.compressed_psum_tree`, when the state holds
"residuals").

A state is {"params": the family's model with its gradients on, "opt":
{"m", "v": {name: float32 tensor}, "step": int32 tensor}} (+ "residuals":
{name: float32 tensor}); `train_step(state, batch)` updates it in place
and returns (state, metrics), metrics {"loss", "grad_norm", "lr"} as
float32 tensors on the model's device.  A batch is the data pipeline's
dict of numpy arrays or tensors; token ids become int64 on the device.
Placing the state and the batch on a mesh (`state_shardings`,
`batch_shardings`) comes with the multi-card slice.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from ..models.api import get_model
from ..models.common import on_device
from .optimizer import AdamWConfig, adamw_update, init_opt_state

__all__ = ["make_train_step", "make_serve_fns", "TrainState", "init_state",
           "state_shardings", "batch_shardings", "value_and_grad",
           "to_device"]

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


def state_shardings(state_shape, mesh):
    raise NotImplementedError(
        "placing the train state on a mesh comes with the multi-card "
        "training slice (train/sharding.py; ROADMAP queue 1)")


def batch_shardings(batch_shape, mesh):
    raise NotImplementedError(
        "placing a batch on a mesh comes with the multi-card training "
        "slice (train/sharding.py; ROADMAP queue 1)")


def to_device(batch: dict, device) -> dict:
    """The batch's arrays on `device`: token ids int64, the rest float32."""
    return {k: on_device(v, device).long() if k in _INTS
            else on_device(v, device).float() for k, v in batch.items()}


def value_and_grad(params, batch: dict, loss_fn: Callable):
    """(loss, {name: gradient}) of `loss_fn(params, batch)`; a parameter
    the loss does not reach gets None."""
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

    def compute_grads(params, batch):
        if microbatch <= 1:
            return grads_of(params, batch)
        B = next(iter(batch.values())).shape[0]
        if B % microbatch:
            raise ValueError(f"microbatch {microbatch} does not divide the "
                             f"batch of {B}")
        mb = B // microbatch
        loss_acc, g_acc = None, None
        for i in range(microbatch):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            l, g = grads_of(params, part)
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
        loss, grads = compute_grads(params, to_device(batch, params.device))
        if compress_pod and "residuals" in state:
            from .compression import compressed_psum_tree
            grads, state["residuals"] = compressed_psum_tree(
                grads, state["residuals"])
        _, state["opt"], stats = adamw_update(opt_cfg, params, grads,
                                              state["opt"])
        return state, {"loss": loss, **stats}

    return train_step


def make_serve_fns(cfg):
    """(prefill_fn, decode_fn) for the arch family."""
    model = get_model(cfg)

    def prefill_fn(params, tokens, cache_len, **kw):
        return model.prefill(params, tokens, cfg, cache_len=cache_len, **kw)

    def decode_fn(params, token, cache, pos):
        return model.decode_step(params, token, cache, pos, cfg)

    return prefill_fn, decode_fn
