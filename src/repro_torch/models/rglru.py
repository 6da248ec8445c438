"""RecurrentGemma-style hybrid (RG-LRU + local attention, arXiv:2402.19427):
the hybrid family, pattern (rec, rec, attn) — 1 attention per 2 recurrent.

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)          # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          # input gate
    a_t = exp(c * softplus(Lambda) * (-r_t))      # in (0,1), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Port of `repro.models.rglru`: `init_params` returns a `RecurrentGemma`
module (embedding, a `ModuleList` of layers in layer order, the final
norm, the unembedding unless tied), and `forward`, `loss_fn`,
`init_cache`, `prefill` and `decode_step` keep the reference's signatures
with that module in place of the params pytree.  The reference stacks
each pattern position's layers into a group for `lax.scan` and keeps the
remainder as an unstacked tail; `models.convert` maps group p's slice g
to layer g * len(pattern) + p and tail entry i to layer G * len(pattern)
+ i, and `layer_params(params, cfg, i)` is layer i.  While a graph is
recorded `forward` runs the reference's remat on that flat list: each
pattern repeat (layers g * len(pattern) ... + len(pattern) - 1) is
checkpointed and each layer in it, each tail layer is checkpointed, and
each chunk of the recurrence is (the gates and the scan of one chunk live
only while its backward runs).  `loss_fn` is the chunked cross-entropy of
the hidden states after the prefix.

Prefill runs the recurrence in chunks of 256 carrying a float32 boundary
state, as the reference does; inside a chunk the reference's
`lax.associative_scan` is a log-depth doubling scan (eight rounds of
products and sums for a chunk of 256; no cumulative product, which would
underflow where a reaches ~4e-4).  The state carried out of the prompt is
the state after its last real step: the reference's carries the padded
steps past it when the prompt is longer than one chunk and not a whole
number of them (ROADMAP R8).  Under a recorded graph the scan's rounds
and the carried state's fold are out of place (the same numbers).
Decode is the O(1) step.  The cache is the
reference's list in layer order: an attention layer's K/V ring of
min(cache_len, window) slots (position p at slot p % ring), a recurrent
layer's conv state (B, 3, w) in the activation dtype and LRU state (B, w)
in float32; `decode_step` writes it in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .attention import Attention
from .common import (DTYPES, Dense, Embedding, LanguageModel, RMSNorm, _param,
                     build, check_model, normal_, recording, run_layers,
                     silu)
from .mlp import GatedMLP

__all__ = ["RecLayer", "AttnLayer", "RecurrentGemma", "init_params",
           "layer_params", "forward", "loss_fn", "init_cache", "prefill",
           "decode_step", "LRU_C", "MODEL"]

LRU_C = 8.0
CONV_WIDTH = 4


def _lru_width(cfg):
    return cfg.recurrent.lru_width or cfg.d_model


def _pattern(cfg):
    pat = cfg.recurrent.pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def _group_split(cfg):
    """n_layers = G full pattern repeats + a tail of pattern[:tail_n]."""
    plen = len(cfg.recurrent.pattern)
    G = cfg.n_layers // plen
    tail_n = cfg.n_layers - G * plen
    return G, tail_n


def _conv_stream(x, w, b, state=None):
    W = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W)) + b
    if state is None:
        return y
    return y, xp[:, -(W - 1):]


def _linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0: the reference's
    `associative_scan` with (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2), as
    ceil(log2 T) doubling rounds (Hillis-Steele), each a product and a sum
    over the whole chunk.  Overwrites a and b (b becomes h) unless a graph
    is recorded; then each round builds new tensors from the same
    products and sums."""
    T = a.shape[1]
    inplace = not (recording(a) or recording(b))
    off = 1
    while off < T:
        if inplace:
            b[:, off:] += a[:, off:] * b[:, :-off]
        else:
            b = torch.cat([b[:, :off], b[:, off:] + a[:, off:] * b[:, :-off]],
                          dim=1)
        if 2 * off < T:                  # the last round needs no a
            if inplace:
                a[:, off:] = a[:, off:] * a[:, :-off]
            else:
                a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


class RecLayer(nn.Module):
    """A recurrent layer: the reference's `_init_rec_block` params and
    its MLP."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        d, w = cfg.d_model, _lru_width(cfg)
        kw = dict(device=device, dtype=dtype)
        gkw = dict(generator=generator, **kw)
        self.cfg = cfg
        self.ln = RMSNorm(d, eps=cfg.norm_eps, **kw)
        self.in_x = Dense(d, w, **gkw)
        self.in_gate = Dense(d, w, **gkw)
        self.conv_w = _param(normal_((CONV_WIDTH, w), 0.1, **gkw))
        self.conv_b = _param(torch.zeros((w,), **kw))
        self.gate_a = Dense(w, w, **gkw)
        self.gate_x = Dense(w, w, **gkw)
        self.lam = _param(torch.full((w,), 0.5, dtype=torch.float32,
                                     device=device))   # Lambda, pre-softplus
        self.out = Dense(w, d, **gkw)
        self.ln2 = RMSNorm(d, eps=cfg.norm_eps, **kw)
        self.mlp = GatedMLP(d, cfg.d_ff, **gkw)

    def gates(self, xb):
        """RG-LRU gate math for a (B, T, w) slice -> (a, b) recurrence
        coefficients, float32."""
        r = torch.sigmoid(self.gate_a(xb).float())
        i = torch.sigmoid(self.gate_x(xb).float())
        log_a = -LRU_C * F.softplus(self.lam) * r
        a = torch.exp(log_a)
        b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
            * (i * xb.float())
        return a, b

    def rglru(self, xb, h0=None, chunk: int = 256):
        """xb (B, S, w), the conv'd branch input -> (y in xb's dtype,
        h_last float32).  One step from h0 when S == 1 and h0 is given;
        otherwise chunks of `chunk`, the carried state folded into each
        chunk's first step (`b_0 += a_0 h`), each chunk checkpointed while
        a graph is recorded."""
        if xb.shape[1] == 1 and h0 is not None:
            a, b = self.gates(xb)
            h = a[:, 0] * h0 + b[:, 0]
            return h[:, None].to(xb.dtype), h
        B, S, w = xb.shape
        h = torch.zeros((B, w), dtype=torch.float32, device=xb.device) \
            if h0 is None else h0
        Q = min(chunk, S)
        remat = recording(xb) or recording(self.lam)
        ys = []
        for j in range(0, S, Q):
            hs = checkpoint(self._chunk, xb[:, j:j + Q], h,
                            use_reentrant=False) if remat \
                else self._chunk(xb[:, j:j + Q], h)
            h = hs[:, -1]
            ys.append(hs.to(xb.dtype))
        return torch.cat(ys, dim=1), h

    def _chunk(self, xj, h):
        """The states of one chunk xj (B, T, w) from the carried h: the
        gates, h folded into the first step (`b_0 += a_0 h`), the scan."""
        aj, bj = self.gates(xj)
        if recording(aj) or recording(h):
            bj = torch.cat([bj[:, :1] + aj[:, :1] * h[:, None], bj[:, 1:]],
                           dim=1)
        else:
            bj[:, 0] += aj[:, 0] * h
        return _linear_scan(aj, bj)

    def forward(self, x, conv_state=None, lru_state=None):
        """The reference's `_rec_apply`: (out) or, with a conv state,
        (out, (conv state, LRU state))."""
        act = self.cfg.act
        res = x
        xi = self.ln(x)
        xb = self.in_x(xi)
        gate = self.in_gate(xi)
        if conv_state is None:
            xb = _conv_stream(xb, self.conv_w, self.conv_b)
            new_conv = None
        else:
            xb, new_conv = _conv_stream(xb, self.conv_w, self.conv_b,
                                        state=conv_state)
        y, h_last = self.rglru(xb, lru_state)
        y = y * silu(gate)
        x = res + self.out(y)
        x = x + self.mlp(self.ln2(x), act)
        if conv_state is None:
            return x
        return x, (new_conv, h_last)


class AttnLayer(nn.Module):
    """A local-attention layer: the reference's `_init_attn_block` params
    and its MLP."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.attn = Attention(cfg, generator=generator, **kw)
        self.ln2 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.mlp = GatedMLP(cfg.d_model, cfg.d_ff, generator=generator, **kw)

    def ffn(self, x):
        return x + self.mlp(self.ln2(x), self.cfg.act)


class RecurrentGemma(LanguageModel):
    def __init__(self, cfg, *, device, generator=None):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"RecurrentGemma serves the hybrid family, not "
                             f"{cfg.family!r}")
        dtype = DTYPES[cfg.param_dtype]
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.layers = nn.ModuleList(
            (RecLayer if kind == "rec" else AttnLayer)(cfg, **kw)
            for kind in _pattern(cfg))
        self.ln_f = RMSNorm(cfg.d_model, eps=cfg.norm_eps, device=device,
                            dtype=dtype)
        self.unembed = None if cfg.tie_embeddings else \
            Dense(cfg.d_model, cfg.padded_vocab, **kw)

    def forward(self, tokens, prefix_embeds=None, kv_chunk: int = 512,
                return_hidden: bool = False, cfg=None):
        """`cfg` (the model's own when None) may differ from it in `remat`
        and `remat_group` alone."""
        cfg = cfg or self.cfg
        x = self.embed_inputs(tokens, prefix_embeds)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]

        def layer_fn(layer):
            if isinstance(layer, RecLayer):
                return layer

            def f(x):
                x = x + layer.attn(layer.ln1(x), positions, kv_chunk=kv_chunk)
                return layer.ffn(x)
            return f

        G, tail_n = _group_split(cfg)
        plen = len(cfg.recurrent.pattern)
        groups = [list(range(g * plen, (g + 1) * plen)) for g in range(G)] \
            + [[G * plen + i] for i in range(tail_n)]
        x = run_layers([layer_fn(layer) for layer in self.layers], x, groups,
                       self.remat(cfg))
        x = self.ln_f(x)
        aux = x.new_zeros((), dtype=torch.float32)
        if return_hidden:
            return x, aux
        return self.logits(x), aux


MODEL = RecurrentGemma  # the family's model class


def init_params(seed, cfg, *, device=None) -> RecurrentGemma:
    """The reference's `init_params(key, cfg)`: `seed` is an int or a
    `torch.Generator` on `device` (the card unless device="cpu"; "meta"
    allocates nothing)."""
    return build(RecurrentGemma, seed, cfg, device)


def layer_params(params: RecurrentGemma, cfg, i: int) -> nn.Module:
    """Layer i (the reference's group slice or tail entry)."""
    check_model(params, cfg)
    return params.layers[i]


def forward(params: RecurrentGemma, tokens, cfg, prefix_embeds=None,
            kv_chunk: int = 512, return_hidden: bool = False):
    """tokens (B, S) -> (logits (B, S_total, padded_vocab), 0.0)."""
    check_model(params, cfg)
    return params(tokens, prefix_embeds, kv_chunk, return_hidden, cfg)


def loss_fn(params: RecurrentGemma, batch, cfg, **_):
    """The chunked cross-entropy of the hidden states after the prefix
    (batch as `transformer.loss_fn` takes it)."""
    x, _ = forward(params, batch["tokens"], cfg,
                   prefix_embeds=batch.get("prefix_embeds"),
                   return_hidden=True)
    return params.loss_of_hidden(x, batch)


def _ring(cfg, cache_len: int) -> int:
    return min(cache_len, cfg.window or cache_len)


def init_cache(cfg, batch: int, cache_len: int, dtype, device=None) -> list:
    """The mixed cache, one entry a layer: an attention layer's K/V ring,
    a recurrent layer's conv and LRU state."""
    w = _lru_width(cfg)
    hd = cfg.resolved_head_dim
    dev = resolve_device(device)
    cache = []
    for kind in _pattern(cfg):
        if kind == "attn":
            shape = (batch, _ring(cfg, cache_len), cfg.n_kv, hd)
            cache.append({"k": torch.zeros(shape, dtype=dtype, device=dev),
                          "v": torch.zeros(shape, dtype=dtype, device=dev)})
        else:
            cache.append({
                "conv": torch.zeros((batch, CONV_WIDTH - 1, w), dtype=dtype,
                                    device=dev),
                "h": torch.zeros((batch, w), dtype=torch.float32,
                                 device=dev)})
    return cache


@torch.no_grad()
def prefill(params: RecurrentGemma, tokens, cfg, cache_len: int,
            prefix_embeds=None, kv_chunk: int = 512):
    """Run the prompt; (last logits (B, 1, V), cache).  An attention
    layer's ring keeps the last min(ring, S) positions at p % ring."""
    check_model(params, cfg)
    x = params.embed_inputs(tokens, prefix_embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None, :]
    cache = init_cache(cfg, B, cache_len, x.dtype, device=x.device)
    win = _ring(cfg, cache_len)
    take = min(win, S)
    slots = torch.remainder(torch.arange(S - take, S, device=x.device), win)
    for layer, c in zip(params.layers, cache):
        if isinstance(layer, RecLayer):
            x, (conv_s, h_s) = layer(x, conv_state=c["conv"])
            c["conv"].copy_(conv_s)
            c["h"].copy_(h_s)
        else:
            h, (k, v) = layer.attn(layer.ln1(x), positions,
                                   kv_chunk=kv_chunk, with_cache=True)
            x = layer.ffn(x + h)
            c["k"][:, slots] = k[:, S - take:]
            c["v"][:, slots] = v[:, S - take:]
    x = params.ln_f(x)
    return params.logits(x[:, -1:]), cache


@torch.no_grad()
def decode_step(params: RecurrentGemma, token, cache: list, pos: int, cfg):
    """One decode step.  token (B, 1); pos: the absolute position (an int);
    returns (logits (B, 1, V), cache), the cache written in place."""
    check_model(params, cfg)
    pos = int(pos)
    x = params.embed_inputs(token)
    for layer, c in zip(params.layers, cache):
        if isinstance(layer, RecLayer):
            x, (conv_s, h_s) = layer(x, conv_state=c["conv"],
                                     lru_state=c["h"])
            c["conv"].copy_(conv_s)
            c["h"].copy_(h_s)
        else:
            h, _, _ = layer.attn.decode(layer.ln1(x), c["k"], c["v"], pos)
            x = layer.ffn(x + h)
    return params.logits(params.ln_f(x)), cache
