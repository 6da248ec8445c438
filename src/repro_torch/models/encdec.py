"""Encoder-decoder transformer backbone (SeamlessM4T-v2's): the encdec
family.

Port of `repro.models.encdec`: `init_params` returns an `EncDec` module
(embedding, the encoder's and decoder's `ModuleList`s, the encoder's and
the decoder's final norms, the unembedding), and `encode`, `forward`,
`loss_fn`, `init_cache`, `prefill` and `decode_step` keep the reference's
signatures with that module in place of the params pytree
(`models.convert` unstacks the reference's blocks when it stacks them,
`scan_layers=True`, and takes its lists as they are otherwise).  While a
graph is recorded and the config scans its layers, the encoder and the
decoder each run under the reference's two-level remat
(`common.run_layers`); `loss_fn` is the decoder's chunked cross-entropy,
untied.

The audio frontend is a stub, as in the reference: the caller gives the
encoder frame embeddings (B, S_src, d).  The encoder is non-causal; each
decoder block runs causal self-attention, then cross-attention over the
encoder output (no RoPE), then its MLP.  The cache is `{"k", "v"}`, the
self-attention rings (n_layers_decoder, B, cache_len, n_kv, hd), and
`{"xk", "xv"}`, the cross K/V computed once from the encoder output
(n_layers_decoder, B, S_src, n_kv, hd); `decode_step` writes the new
token's self K/V into the rings in place and reads every cross slot.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .attention import Attention
from .common import (DTYPES, Dense, Embedding, LanguageModel, RMSNorm, build,
                     check_model, on_device, remat_groups, run_layers)
from .mlp import GatedMLP

__all__ = ["EncBlock", "DecBlock", "EncDec", "init_params", "encode",
           "forward", "loss_fn", "init_cache", "prefill", "decode_step",
           "MODEL"]


class EncBlock(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.attn = Attention(cfg, generator=generator, **kw)
        self.ln2 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.mlp = GatedMLP(cfg.d_model, cfg.d_ff, generator=generator, **kw)

    def forward(self, x, positions, kv_chunk: int):
        """The reference's `_enc_apply` (non-causal)."""
        x = x + self.attn(self.ln1(x), positions, causal=False,
                          kv_chunk=kv_chunk)
        return x + self.mlp(self.ln2(x), self.cfg.act)


class DecBlock(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.attn = Attention(cfg, generator=generator, **kw)
        self.lnx = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.cross = Attention(cfg, generator=generator, **kw)
        self.ln2 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.mlp = GatedMLP(cfg.d_model, cfg.d_ff, generator=generator, **kw)

    def forward(self, x, enc_out, positions, kv_chunk: int,
                with_cache: bool = False):
        """The reference's `_dec_apply`; with `with_cache`, (x, (k, v, xk,
        xv)): the self K/V (after RoPE) and the cross K/V."""
        h, kv = self.attn(self.ln1(x), positions, kv_chunk=kv_chunk,
                          with_cache=True)
        x = x + h
        hx, xkv = self.cross(self.lnx(x), positions, kv_source=enc_out,
                             causal=False, kv_chunk=kv_chunk, with_cache=True)
        x = x + hx
        x = x + self.mlp(self.ln2(x), self.cfg.act)
        if with_cache:
            return x, kv + xkv
        return x


class EncDec(LanguageModel):
    def __init__(self, cfg, *, device, generator=None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDec serves the encdec family, not "
                             f"{cfg.family!r}")
        dtype = DTYPES[cfg.param_dtype]
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.enc = nn.ModuleList(EncBlock(cfg, **kw)
                                 for _ in range(cfg.n_layers))
        self.dec = nn.ModuleList(DecBlock(cfg, **kw)
                                 for _ in range(cfg.n_layers_decoder))
        norm = dict(eps=cfg.norm_eps, device=device, dtype=dtype)
        self.ln_enc = RMSNorm(cfg.d_model, **norm)
        self.ln_f = RMSNorm(cfg.d_model, **norm)
        self.unembed = Dense(cfg.d_model, cfg.padded_vocab, **kw)

    def encode(self, src_embeds, kv_chunk: int = 512, cfg=None):
        cfg = cfg or self.cfg
        adt = DTYPES[cfg.activation_dtype]
        x = on_device(src_embeds, self.device).to(adt)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = run_layers([lambda x, bp=bp: bp(x, positions, kv_chunk)
                        for bp in self.enc], x,
                       remat_groups(cfg.n_layers, cfg.remat_group),
                       cfg.scan_layers and self.remat(cfg))
        return self.ln_enc(x)

    def forward(self, batch_src, tgt_tokens, kv_chunk: int = 512,
                return_hidden: bool = False, cfg=None):
        """`cfg` (the model's own when None) may differ from it in `remat`
        and `remat_group` alone."""
        cfg = cfg or self.cfg
        enc_out = self.encode(batch_src, kv_chunk, cfg)
        x = self.embed_inputs(tgt_tokens)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = run_layers([lambda x, bp=bp: bp(x, enc_out, positions, kv_chunk)
                        for bp in self.dec], x,
                       remat_groups(cfg.n_layers_decoder, cfg.remat_group),
                       cfg.scan_layers and self.remat(cfg))
        x = self.ln_f(x)
        aux = x.new_zeros((), dtype=torch.float32)
        if return_hidden:
            return x, aux
        return self.logits(x), aux


MODEL = EncDec  # the family's model class


def init_params(seed, cfg, *, device=None) -> EncDec:
    """The reference's `init_params(key, cfg)`: `seed` is an int or a
    `torch.Generator` on `device` (the card unless device="cpu"; "meta"
    allocates nothing)."""
    return build(EncDec, seed, cfg, device)


def encode(params: EncDec, src_embeds, cfg, kv_chunk: int = 512):
    """src_embeds (B, S_src, d) frame embeddings -> the encoder output."""
    check_model(params, cfg)
    return params.encode(src_embeds, kv_chunk)


def forward(params: EncDec, batch_src, tgt_tokens, cfg, kv_chunk: int = 512,
            return_hidden: bool = False):
    """batch_src: (B, S_src, d) frame embeddings; tgt_tokens (B, S_tgt) ->
    (logits (B, S_tgt, padded_vocab), 0.0)."""
    check_model(params, cfg)
    return params(batch_src, tgt_tokens, kv_chunk, return_hidden, cfg)


def loss_fn(params: EncDec, batch, cfg, **_):
    """The encoder on `batch["src_embeds"]` (B, S_src, d), then the
    decoder's chunked cross-entropy (untied) on tokens/labels/mask."""
    x, _ = forward(params, batch["src_embeds"], batch["tokens"], cfg,
                   return_hidden=True)
    return params.loss_of_hidden(x, batch)


def init_cache(cfg, batch: int, cache_len: int, dtype, device=None,
               src_len: int | None = None) -> dict:
    """Self K/V rings of `cache_len` slots and cross K/V of `src_len`
    positions (cache_len when None, as `launch.specs` sizes them)."""
    hd = cfg.resolved_head_dim
    L = cfg.n_layers_decoder
    src_len = cache_len if src_len is None else src_len
    dev = resolve_device(device)

    def zeros(n):
        return torch.zeros((L, batch, n, cfg.n_kv, hd), dtype=dtype,
                           device=dev)
    return {"k": zeros(cache_len), "v": zeros(cache_len),
            "xk": zeros(src_len), "xv": zeros(src_len)}


@torch.no_grad()
def prefill(params: EncDec, tokens, cfg, cache_len: int, src_embeds=None,
            kv_chunk: int = 512, **_):
    """Encode the source, run the decoder's prompt; (last logits (B, 1, V),
    cache).  The self rings keep the last min(cache_len, S) positions at
    p % cache_len."""
    check_model(params, cfg)
    if src_embeds is None:
        raise ValueError("the encdec family's prefill needs src_embeds")
    enc_out = params.encode(src_embeds, kv_chunk)
    x = params.embed_inputs(tokens)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None, :]
    cache = init_cache(cfg, B, cache_len, x.dtype, device=x.device,
                       src_len=enc_out.shape[1])
    take = min(cache_len, S)
    slots = torch.remainder(torch.arange(S - take, S, device=x.device),
                            cache_len)
    for i, bp in enumerate(params.dec):
        x, (k, v, xk, xv) = bp(x, enc_out, positions, kv_chunk,
                               with_cache=True)
        cache["k"][i][:, slots] = k[:, S - take:]
        cache["v"][i][:, slots] = v[:, S - take:]
        cache["xk"][i] = xk
        cache["xv"][i] = xv
    x = params.ln_f(x)
    return params.logits(x[:, -1:]), cache


@torch.no_grad()
def decode_step(params: EncDec, token, cache: dict, pos: int, cfg):
    """One decode step.  token (B, 1); pos: the absolute position (an int);
    returns (logits (B, 1, V), cache), the self rings written in place."""
    check_model(params, cfg)
    pos = int(pos)
    x = params.embed_inputs(token)
    for i, bp in enumerate(params.dec):
        h, _, _ = bp.attn.decode(bp.ln1(x), cache["k"][i], cache["v"][i],
                                 pos)
        x = x + h
        hx, _, _ = bp.cross.decode(bp.lnx(x), cache["xk"][i],
                                   cache["xv"][i], pos, cross=True)
        x = x + hx
        x = x + bp.mlp(bp.ln2(x), cfg.act)
    return params.logits(params.ln_f(x)), cache
