"""Gated MLPs (SwiGLU / GeGLU) and Mixture-of-Experts layers.

Port of `repro.models.mlp`.  MoE routing is the reference's dense
dispatch under a capacity, group-local per batch row:
  * the router's softmax, its top-k (ties toward the lower expert index,
    as `lax.top_k`: a stable descending sort), the gates renormalised
    over the k picks before the keep mask;
  * capacity cap = max(1, ceil(int(capacity_factor * Tg * k) / E)) per
    (row, expert); queue positions are a cumsum over the token-major
    (Tg * k) flattening, so the same picks drop;
  * dropped picks scatter to the sentinel slot E * cap and combine as
    zeros; the shared expert is added; the Switch auxiliary loss.
The expert products are batched einsums over the stacked (E, d, dff)
weights (every expert's weights are read, as the reference's are).
Under a mesh the reference's anchors (`meshctx.constrain_tokens` on the
dispatch, `constrain_group_expert` around the expert products) move the
groups and experts between ranks; the routing, the dispatch, the expert
products and the combine run on each rank's local blocks.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import Dense, _param, gelu, normal_, silu

__all__ = ["GatedMLP", "MoE"]


def _act(name: str):
    return silu if name == "silu" else gelu


class GatedMLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, device, dtype,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.gate = Dense(d_model, d_ff, **kw)
        self.up = Dense(d_model, d_ff, **kw)
        self.down = Dense(d_ff, d_model, **kw)

    def forward(self, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
        return self.down(_act(act)(self.gate(x)) * self.up(x))


class MoE(nn.Module):
    """Router (d, E), expert stacks gate_w/up_w (E, d, dff) and down_w
    (E, dff, d), and the shared expert when the config has one."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        mo = cfg.moe
        d, dff, E = cfg.d_model, mo.d_ff_expert, mo.num_experts
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.cfg = cfg
        self.router = Dense(d, E, **kw)
        self.gate_w = _param(normal_((E, d, dff), 1.0 / math.sqrt(d), **kw))
        self.up_w = _param(normal_((E, d, dff), 1.0 / math.sqrt(d), **kw))
        self.down_w = _param(normal_((E, dff, d), 1.0 / math.sqrt(dff),
                                     **kw))
        self.shared = GatedMLP(d, cfg.d_ff, **kw) if mo.shared_expert \
            else None

    def route(self, x: torch.Tensor):
        """The routing of x (B, S, d): (probs (B, S, E) float32, sel
        (B, S, k), gates (B, S, k) float32 after the keep mask, keep
        (B, S, k), slot (B, S*k): each pick's queue slot, E*cap if
        dropped, cap)."""
        from ..train.meshctx import Local
        logits = self.router(x).float()                       # (G, Tg, E)
        probs = torch.softmax(logits, dim=-1)
        # the picks and the queues are local to each row (a group):
        # under DTensor they run on the local rows (`Local`), and all but
        # probs come back local
        p = Local(x).local(probs)
        order = torch.sort(p, dim=-1, descending=True, stable=True)[1]
        sel = order[..., :self.cfg.moe.top_k]                 # (G, Tg, k)
        return (probs, sel) + self.queue(p, sel)

    def queue(self, probs: torch.Tensor, sel: torch.Tensor):
        """The picks `sel` (G, Tg, k) of `probs` (G, Tg, E) into the
        expert queues: (gates (G, Tg, k) float32 after the keep mask, keep,
        slot, cap) as `route` returns them."""
        mo = self.cfg.moe
        G, Tg, k = sel.shape
        E = mo.num_experts
        gate_vals = torch.gather(probs, -1, sel)
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
        cap = max(1, -(-int(mo.capacity_factor * Tg * k) // E))
        sel_flat = sel.reshape(G, Tg * k)
        one_hot_e = F.one_hot(sel_flat, E)                    # (G, Tg*k, E)
        pos_in_e = torch.cumsum(one_hot_e, dim=1) - one_hot_e
        pos = torch.gather(pos_in_e, 2, sel_flat[..., None])[..., 0]
        keep = pos < cap
        gate_vals = gate_vals * keep.reshape(G, Tg, k)
        slot = torch.where(keep, sel_flat * cap + pos,
                           torch.full_like(pos, E * cap))
        return gate_vals, keep.reshape(G, Tg, k), slot, cap

    def forward(self, x: torch.Tensor, act: str = "silu"):
        """x: (B, S, d) -> (y (B, S, d), aux_loss); a group is a row."""
        from ..train.meshctx import (Local, constrain_group_expert,
                                     constrain_tokens)
        mo = self.cfg.moe
        B, S, d = x.shape
        E, k = mo.num_experts, mo.top_k
        Tg = S
        x = constrain_tokens(x)                               # (G, Tg, d)
        probs, sel, gate_vals, _, slot, cap = self.route(x)
        # group-local scatter of token ids into the expert queues; the
        # sentinel slot E*cap (dropped picks) is cut off.  Under DTensor
        # the dispatch and the combine run on each rank's local groups,
        # and the expert products on its local (groups, experts) blocks
        # between the anchors (`Local`: DTensor has no rule for the
        # scatter into a fresh tensor, and its einsum fails on these
        # blocks)
        r = Local(x)
        xl = r.x
        G = xl.shape[0]
        token_id = torch.arange(Tg, device=xl.device).repeat_interleave(k)
        slot_token = torch.full((G, E * cap + 1), Tg, dtype=torch.int64,
                                device=xl.device)
        slot_token.scatter_(1, slot, token_id.expand(G, Tg * k))
        rows = torch.arange(G, device=xl.device)[:, None]
        xt_pad = torch.cat([xl, xl.new_zeros((G, 1, d))], dim=1)
        xe = r.wrap(xt_pad[rows, slot_token[:, :-1]].reshape(G, E, cap, d))
        xe = constrain_tokens(xe)            # dispatch: groups everywhere
        xe = constrain_group_expert(xe)      # -> all-to-all to expert shards
        ge = Local(xe, dims=(0, 1))
        gate_w, up_w, down_w = (ge.weight(w, {0: 1}).to(x.dtype) for w in
                                (self.gate_w, self.up_w, self.down_w))
        g = torch.einsum("gecd,edf->gecf", ge.x, gate_w)
        u = torch.einsum("gecd,edf->gecf", ge.x, up_w)
        h = _act(act)(g) * u
        ye = ge.wrap(torch.einsum("gecf,efd->gecd", h, down_w), xe.shape)
        ye = constrain_group_expert(ye)
        ye = constrain_tokens(ye)            # all-to-all back to token shards
        # group-local combine; a dropped pick reads the zero sentinel row
        yel = r.local(ye)
        ye_flat = torch.cat([yel.reshape(G, E * cap, d),
                             yel.new_zeros((G, 1, d))], dim=1)
        yk = ye_flat[rows, slot].reshape(G, Tg, k, d)
        y = r.wrap(torch.einsum("gtkd,gtk->gtd", yk.float(), gate_vals
                                ).to(x.dtype))
        if self.shared is not None:
            y = y + self.shared(x, act)
        # load-balance auxiliary loss (Switch style)
        me = probs.mean(dim=(0, 1))                           # (E,)
        ce = r.wrap(F.one_hot(sel[..., 0], E).float()).mean(dim=(0, 1))
        aux = E * torch.sum(me * ce)
        return y, aux
