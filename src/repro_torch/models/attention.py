"""GQA attention: chunked (flash-style) prefill path + cached decode.

Port of `repro.models.attention`, in plain torch: the online softmax over
q and kv chunks of the reference's `_chunked_attn`, as Python loops over
the chunks (no `scaled_dot_product_attention`: a faster attention is
later work, measured against this one).  Supports:
  * grouped-query attention (n_kv < n_heads; head h reads kv head h // G,
    `repeat_interleave`), MQA (n_kv = 1);
  * optional QKV bias (qwen2), head_dim != d_model/n_heads (gemma);
  * causal masking, local (sliding-window) masking;
  * cross-attention (no causal mask, separate KV source);
  * a decode step against a ring-buffered KV cache.

Masked scores are NEG_INF = -1e30 (not -inf) and the normalizer is clamped
at 1e-30, as in the reference, so fully masked padded rows stay finite.
Under a mesh (DTensor inputs) the online softmax runs on each rank's
local (batch rows, heads) blocks (`_chunked_attn`); the reference pads
heads to its mesh's model axis, and here a head count that the model
axis does not divide is computed whole on every rank of that axis: the
projection's columns are gathered before its heads are split out
(`_split_heads`), whatever the plan shards them into.  Decode runs on
DTensors against a cache placed by the dry run's rule.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .common import Dense, recording, rope

__all__ = ["Attention", "NEG_INF"]

NEG_INF = -1e30


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """x (..., n * hd) as (..., n, hd).  A DTensor projection whose
    columns the mesh shards into blocks that cut across heads (the plan
    shards the `n * hd` columns over "model" whenever its size divides
    them, also where it does not divide `n`: the k and v projections of
    most GQA models) is made whole there first (`meshctx.unshard`)."""
    from ..train.meshctx import unshard
    x = unshard(x, -1, n)
    return x.reshape(x.shape[:-1] + (n, hd))


def _chunked_attn(q, k, v, **kw) -> torch.Tensor:
    """`_attn` of q, k, v (B, S, heads, hd); of DTensors, on local blocks.

    The online softmax is local to each (batch row, head), and DTensor's
    einsum decomposition views a permuted local block whose layout its
    global strides misstate, so under DTensor q, k and v are anchored
    (batch over the data axes, heads over "model" when the model axis
    divides them) and `_attn` runs on each rank's local blocks
    (`meshctx.Local`).  When the model axis divides both head counts, a
    q head of a local block reads the kv heads of the same block (head h
    reads kv head h // G, and both counts split evenly).  When it divides
    the q heads alone (GQA with fewer kv heads than the axis), the kv
    heads stay whole on every rank and each rank reads those of its own
    q heads (their gradients partial over the model axis).  The
    reference pads other head counts to the model axis; here they are
    computed whole on every rank of the model axis."""
    from torch.distributed.tensor import DTensor
    if not isinstance(q, DTensor):
        return _attn(q, k, v, **kw)
    from ..train.meshctx import Local, constrain_batch, model_axis_size
    msz = model_axis_size()
    split_q = q.shape[2] % msz == 0
    split_kv = split_q and k.shape[2] % msz == 0
    q = constrain_batch(q, 0, model_dim=2 if split_q else None)
    k, v = (constrain_batch(t, 0, model_dim=2 if split_kv else None)
            for t in (k, v))
    blk = Local(q, dims=(0, 2) if split_q else (0,))
    if split_kv or not split_q:
        kl, vl = blk.local(k), blk.local(v)
    else:
        G = q.shape[2] // k.shape[2]
        lo = blk.start(2)
        idx = torch.arange(lo, lo + blk.x.shape[2], device=blk.x.device)
        kl, vl = (blk.shared(t)[:, :, idx // G] for t in (k, v))
    return blk.wrap(_attn(blk.x, kl, vl, **kw), q.shape)


def _attn(q, k, v, *, causal: bool, window: int, q_offset: int,
          kv_chunk: int = 512, q_chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention, chunked over both q and kv.

    q: (B, Sq, H, hd); k/v: (B, Sk, K, hd) with H % K == 0.  K/V are
    expanded to the H heads (head h <- kv head h // G).  q and kv are
    padded to whole chunks; padded kv positions are masked (kv_pos < Sk)
    and padded q rows sliced off.  Returns (B, Sq, H, hd) in q's dtype.
    While a graph is recorded each q block is checkpointed."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)     # (B, Sk, H, hd); order k*G+g
        v = v.repeat_interleave(G, dim=2)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq = -(-Sq // q_chunk)
    nk = -(-Sk // kv_chunk)
    qp, kp = nq * q_chunk - Sq, nk * kv_chunk - Sk
    if qp:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, qp))
    if kp:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, kp))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, kp))
    dev = q.device

    def q_block(qi, i):
        qi = qi.float() * scale
        q_pos = q_offset + i * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, q_chunk, H), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, q_chunk, H), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, q_chunk, H, hd), dtype=torch.float32,
                          device=dev)
        for j in range(nk):
            kj = k[:, j * kv_chunk:(j + 1) * kv_chunk].float()
            vj = v[:, j * kv_chunk:(j + 1) * kv_chunk].float()
            kv_pos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqhe,bche->bqhc", qi, kj)
            valid = (kv_pos < Sk)[None, None, None, :]
            if causal:
                cm = kv_pos[None, :] <= q_pos[:, None]           # (qc, c)
                if window:
                    cm = cm & (kv_pos[None, :] > q_pos[:, None] - window)
                valid = valid & cm[None, :, None, :]
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bqhc,bche->bqhe",
                                                       p, vj)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        return out.to(q.dtype)

    # under a recorded graph each q block is checkpointed (the
    # reference's per-block remat): a layer's backward holds one block's
    # kv loop at a time
    remat = any(recording(t) for t in (q, k, v))
    blocks = [checkpoint(q_block, q[:, i * q_chunk:(i + 1) * q_chunk], i,
                         use_reentrant=False) if remat
              else q_block(q[:, i * q_chunk:(i + 1) * q_chunk], i)
              for i in range(nq)]
    return torch.cat(blocks, dim=1)[:, :Sq]


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dim.  Of a DTensor whose last dim (the cache
    slots) the mesh shards, it is taken on the shards, with the max and
    the sum reduced across them (DTensor's softmax would gather the
    scores first)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(s, DTensor):
        return torch.softmax(s, dim=-1)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def _ring_valid(slots: torch.Tensor, pos: int, S_cache: int,
                window: int) -> torch.Tensor:
    """Which ring slots hold valid (written, in-window) positions."""
    stored = pos - torch.remainder(pos - slots, S_cache)   # absolute
    ok = stored >= 0
    if window:
        ok = ok & (stored > pos - window)
    return ok


class Attention(nn.Module):
    """q/k/v/o projections of one attention layer (the reference's
    `init_attention` params: q, k, v with `qkv_bias`, o without)."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q = Dense(d, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw)
        self.k = Dense(d, cfg.n_kv * hd, bias=cfg.qkv_bias, **kw)
        self.v = Dense(d, cfg.n_kv * hd, bias=cfg.qkv_bias, **kw)
        self.o = Dense(cfg.n_heads * hd, d, bias=False, **kw)

    def forward(self, x, positions, *, kv_source=None, causal: bool = True,
                kv_chunk: int = 512, q_offset: int = 0,
                with_cache: bool = False):
        """Full attention over x (prefill).  kv_source: an encoder output
        for cross-attention (then causal=False, no RoPE).  Returns y, or
        (y, (k, v)) with `with_cache` (k after RoPE)."""
        from ..train.meshctx import unshard_grad
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        src = x if kv_source is None else kv_source
        q = _split_heads(self.q(x), cfg.n_heads, hd)
        k = _split_heads(self.k(src), cfg.n_kv, hd)
        v = _split_heads(self.v(src), cfg.n_kv, hd)
        if kv_source is None:                  # self-attention gets RoPE
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        window = cfg.window if cfg.attention == "local" else 0
        y = _chunked_attn(q, k, v, causal=causal, window=window,
                          q_offset=q_offset, kv_chunk=kv_chunk)
        y = self.o(unshard_grad(y.reshape(y.shape[:2] + (cfg.n_heads * hd,)),
                                -1, cfg.n_heads))
        if with_cache:
            return y, (k, v)
        return y

    def decode(self, x, cache_k, cache_v, pos: int, *, cross: bool = False):
        """One-token decode against a KV cache.

        x: (B, 1, d); cache_k/v: (B, S_cache, K, hd); pos: the new token's
        absolute position.  For self-attention the new token's K/V are
        written into the caches, in place, at slot `pos % S_cache` (ring
        semantics cover full and local caches; a DTensor cache through
        `meshctx.write`, on each rank's block).  Returns (y, cache_k,
        cache_v)."""
        from ..train.meshctx import unshard, write
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        B = x.shape[0]
        q = _split_heads(self.q(x), cfg.n_heads, hd)
        if not cross:
            k_new = _split_heads(self.k(x), cfg.n_kv, hd)
            v_new = _split_heads(self.v(x), cfg.n_kv, hd)
            positions = torch.full((B, 1), pos, dtype=torch.int64,
                                   device=x.device)
            q = rope(q, positions, cfg.rope_theta)
            k_new = rope(k_new, positions, cfg.rope_theta)
            slot = pos % cache_k.shape[1]
            write(cache_k, k_new.to(cache_k.dtype), dim=1,
                  index=slice(slot, slot + 1))
            write(cache_v, v_new.to(cache_v.dtype), dim=1,
                  index=slice(slot, slot + 1))
        S_cache, K = cache_k.shape[1], cache_k.shape[2]
        G = cfg.n_heads // K
        scale = 1.0 / math.sqrt(hd)
        qg = unshard(q, 2, K).reshape(B, 1, K, G, hd).float() * scale
        s = torch.einsum("bqkgh,bckh->bqgkc", qg, cache_k.float())
        if not cross:
            valid = _ring_valid(torch.arange(S_cache, device=x.device), pos,
                                S_cache,
                                cfg.window if cfg.attention == "local" else 0)
            s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
        w = _softmax(s)
        y = torch.einsum("bqgkc,bckh->bqgkh", w, cache_v.float())
        y = y.movedim(3, 2).reshape(B, 1, cfg.n_heads * hd)  # (K, G) order
        return self.o(y.to(x.dtype)), cache_k, cache_v
