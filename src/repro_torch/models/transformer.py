"""Decoder-only transformer assembly (dense + MoE families, VLM prefix).

Port of `repro.models.transformer`: `init_params` returns a
`Transformer` module (embedding, a `ModuleList` of blocks, the final norm,
the unembedding unless tied), and `forward`, `loss_fn`, `init_cache`,
`prefill` and `decode_step` keep the reference's signatures with that
module in place of the params pytree.  The reference stacks its blocks
for `lax.scan`; here they are a list, run one after the other
(`models.convert` unstacks the reference's), with the reference's
two-level remat (`common.run_layers`) while a graph is recorded and the
config scans its layers.  The KV cache keeps the reference's layout,
`{"k", "v"}` of shape (n_layers, B, cache_len, n_kv, hd), in ring order
(position p at slot p % cache_len); `decode_step` writes the new token's
K/V into it in place.  Logits span `padded_vocab`, in float32 (tied: through the
embedding table).  `loss_fn` is the chunked cross-entropy of the hidden
states after the prefix plus 0.01 x the MoE's auxiliary loss.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .attention import Attention
from .common import (DTYPES, Dense, Embedding, LanguageModel, RMSNorm, build,
                     check_model, remat_groups, run_layers, serving)
from .mlp import GatedMLP, MoE

__all__ = ["Block", "Transformer", "init_params", "forward", "loss_fn",
           "init_cache", "prefill", "decode_step", "MODEL"]


class Block(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.attn = Attention(cfg, generator=generator, **kw)
        self.ln2 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        if cfg.family == "moe":
            self.moe = MoE(cfg, generator=generator, **kw)
        else:
            self.mlp = GatedMLP(cfg.d_model, cfg.d_ff, generator=generator,
                                **kw)

    def ffn(self, x):
        """(mlp or moe output, aux loss)."""
        if self.cfg.family == "moe":
            return self.moe(x, self.cfg.act)
        return self.mlp(x, self.cfg.act), x.new_zeros((), dtype=torch.float32)


class Transformer(LanguageModel):
    def __init__(self, cfg, *, device, generator=None):
        super().__init__()
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"the transformer serves the dense and moe "
                             f"families, not {cfg.family!r}")
        dtype = DTYPES[cfg.param_dtype]
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, eps=cfg.norm_eps, device=device,
                            dtype=dtype)
        self.unembed = None if cfg.tie_embeddings else \
            Dense(cfg.d_model, cfg.padded_vocab, **kw)

    def forward(self, tokens, prefix_embeds=None, kv_chunk: int = 512,
                return_hidden: bool = False, cfg=None):
        """`cfg` (the model's own when None) may differ from it in `remat`
        and `remat_group` alone."""
        from ..train.meshctx import constrain_batch
        cfg = cfg or self.cfg
        x = constrain_batch(self.embed_inputs(tokens, prefix_embeds))
        positions = torch.arange(x.shape[1], device=x.device)[None, :]

        def block_fn(bp):
            def f(carry):
                x, aux = carry
                x = constrain_batch(x)
                x = x + bp.attn(bp.ln1(x), positions, kv_chunk=kv_chunk)
                m, a = bp.ffn(bp.ln2(x))
                return x + m, aux + a
            return f

        x, aux_total = run_layers(
            [block_fn(bp) for bp in self.blocks],
            (x, x.new_zeros((), dtype=torch.float32)),
            remat_groups(cfg.n_layers, cfg.remat_group),
            cfg.scan_layers and self.remat(cfg))
        x = self.ln_f(x)
        if return_hidden:
            return x, aux_total
        return self.logits(x), aux_total


MODEL = Transformer  # the family's model class


def init_params(seed, cfg, *, device=None) -> Transformer:
    """The reference's `init_params(key, cfg)`: `seed` is an int or a
    `torch.Generator` on `device`.  Parameters are drawn on `device` (the
    card unless device="cpu"; "meta" allocates nothing), so a full-width
    model is never staged through host memory."""
    return build(Transformer, seed, cfg, device)


def forward(params: Transformer, tokens, cfg, prefix_embeds=None,
            kv_chunk: int = 512, return_hidden: bool = False):
    """tokens (B, S) -> (logits (B, S_total, padded_vocab), aux)."""
    check_model(params, cfg)
    return params(tokens, prefix_embeds, kv_chunk, return_hidden, cfg)


def loss_fn(params: Transformer, batch, cfg, kv_chunk: int = 512):
    """batch: {tokens (B, S), labels (B, S), mask (B, S)} (+ prefix_embeds
    (B, P, d)), numpy arrays or tensors -> the float32 loss: the chunked
    cross-entropy of the hidden states after the prefix + 0.01 x aux."""
    x, aux = forward(params, batch["tokens"], cfg,
                     prefix_embeds=batch.get("prefix_embeds"),
                     kv_chunk=kv_chunk, return_hidden=True)
    return params.loss_of_hidden(x, batch) + 0.01 * aux


def init_cache(cfg, batch: int, cache_len: int, dtype, device=None) -> dict:
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv, hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


@serving
def prefill(params: Transformer, tokens, cfg, cache_len: int,
            prefix_embeds=None, kv_chunk: int = 512):
    """Run the prompt; (last logits (B, 1, V), cache).  Each layer's K/V go
    to ring slots (position p -> p % cache_len; the last cache_len
    positions are kept).  On placed parameters the cache is placed by the
    dry run's cache rule (`meshctx.place_cache`)."""
    from ..train.meshctx import place_cache, ring_slots, write
    check_model(params, cfg)
    x = params.embed_inputs(tokens, prefix_embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None, :]
    cache = place_cache(init_cache(cfg, B, cache_len, x.dtype,
                                   device=x.device), x)
    take = min(cache_len, S)
    slots = ring_slots(S - take, S, cache_len, x)
    for i, bp in enumerate(params.blocks):
        h, (k, v) = bp.attn(bp.ln1(x), positions, kv_chunk=kv_chunk,
                            with_cache=True)
        x = x + h
        m, _ = bp.ffn(bp.ln2(x))
        x = x + m
        write(cache["k"], k[:, S - take:], layer=i, dim=1, index=slots)
        write(cache["v"], v[:, S - take:], layer=i, dim=1, index=slots)
    x = params.ln_f(x)
    return params.logits(x[:, -1:]), cache


@serving
def decode_step(params: Transformer, token, cache: dict, pos: int, cfg):
    """One decode step.  token (B, 1); pos: the absolute position (an int);
    returns (logits (B, 1, V), cache), the cache written in place."""
    check_model(params, cfg)
    pos = int(pos)
    x = params.embed_inputs(token)
    for i, bp in enumerate(params.blocks):
        h, _, _ = bp.attn.decode(bp.ln1(x), cache["k"][i], cache["v"][i],
                                 pos)
        x = x + h
        m, _ = bp.ffn(bp.ln2(x))
        x = x + m
    return params.logits(params.ln_f(x)), cache
