"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060): the ssm family.

Port of `repro.models.mamba2`: `init_params` returns a `Mamba2` module
(embedding, a `ModuleList` of SSD blocks, the final norm, the unembedding
unless tied), and `forward`, `loss_fn`, `init_state`, `prefill` and
`decode_step` keep the reference's signatures with that module in place
of the params pytree (`models.convert` unstacks the reference's stacked
blocks).  While a graph is recorded the blocks run under the reference's
two-level remat (`common.run_layers`), and `loss_fn` is the chunked
cross-entropy of the hidden states after the prefix.

Chunked SSD (`_ssd_chunked`): the sequence is split into chunks of length
Q; within a chunk the output is the quadratic (attention-like) form with
a decay mask, across chunks it flows through the recurrent chunk states,
carried in float32 by a loop over the chunks.  The reference's three-
operand einsums are pairwise contractions here, so nothing of shape
(B, nc, Q, Q, H, P) is formed, and the decay mask is applied before the
exponential (exp of -inf is 0), so no inf is ever formed above the
diagonal (so its gradient holds no inf x 0 either).  Decode is the O(1)
recurrent update.  The state keeps the
reference's layout, `{"conv": (n_layers, B, W-1, conv_dim)` in the
activation dtype, `"ssd": (n_layers, B, H, P, N)` in float32`}`;
`decode_step` writes it in place.

Shapes: d_inner = expand*d_model, H = d_inner/P heads, state N per head.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .common import (DTYPES, Dense, Embedding, LanguageModel, RMSNorm, _param,
                     build, check_model, normal_, remat_groups, rms_norm,
                     run_layers, serving, silu)

__all__ = ["SSDBlock", "Mamba2", "init_params", "forward", "loss_fn",
           "init_state", "prefill", "decode_step", "ssd_params_per_layer",
           "MODEL"]


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return d_inner, H, s.head_dim, s.state_dim


def ssd_params_per_layer(cfg) -> int:
    d = cfg.d_model
    d_inner, H, P, N = _dims(cfg)
    conv_dim = d_inner + 2 * N
    return (d * (2 * d_inner + 2 * N + H)      # in_proj (z, x, B, C, dt)
            + conv_dim * cfg.ssm.conv_width    # depthwise conv
            + 2 * H                            # A_log, D
            + H                                # dt bias
            + d_inner * d)                     # out_proj


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv.  x (B, S, C), w (W, C).  With a state
    (B, W-1, C) it streams and returns (y, new_state)."""
    W = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W))
    y = y + b
    if state is None:
        return y
    return y, xp[:, -(W - 1):]


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD.

    xh (B, S, H, P); dt (B, S, H) (softplus'ed); A (H,) negative; Bm/Cm
    (B, S, N).  Returns (y (B, S, H, P) in xh's dtype, h_final (B, H, P, N)
    in float32).  A prompt that is not a whole number of chunks is padded
    (dt = 0 there: no decay, no input) and sliced."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    f32 = torch.float32
    xc = xh.reshape(Bsz, nc, Q, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, Q, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, Q, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, Q, N).to(f32)

    dA = dtc * A.to(f32)                              # (B,nc,Q,H) negative
    cum = torch.cumsum(dA, dim=2)                     # within-chunk cumsum
    seg_end = cum[:, :, -1:, :]                       # total chunk decay
    # intra-chunk mask L[i, j] = exp(cum_i - cum_j) for j <= i, else 0:
    # masked to -inf before the exp (above the diagonal cum_i - cum_j > 0)
    Li = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    L = torch.exp(Li.masked_fill(~mask[None, None, :, :, None],
                                 float("-inf")))
    xdt = xc * dtc[..., None]                         # (B,nc,Q,H,P)
    # diagonal (within-chunk) term: (G * L) over k, then against xdt
    G = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)       # (B,nc,Q,Q)
    # in place unless a graph is recorded (exp's backward needs L)
    GL = L * G[..., None] if L.requires_grad or G.requires_grad \
        else L.mul_(G[..., None])                     # (B,nc,Q,Q,H)
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", GL, xdt)
    # chunk states: the contribution of chunk c to the carried state
    decay_out = torch.exp(seg_end - cum)              # (B,nc,Q,H)
    states = torch.einsum("bcqn,bcqhp->bchpn", Bc,
                          xdt * decay_out[..., None])
    # inter-chunk recurrence, one chunk after the other (h before chunk c)
    chunk_decay = torch.exp(seg_end[:, :, 0, :])      # (B,nc,H)
    h = torch.zeros((Bsz, H, P, N), dtype=f32, device=xh.device) \
        if h0 is None else h0.to(f32)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)               # (B,nc,H,P,N)
    decay_in = torch.exp(cum)                         # (B,nc,Q,H)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_prev) \
        * decay_in[..., None]
    y = (y_diag + y_off).reshape(Bsz, nc * Q, H, P)
    return y[:, :S].to(xh.dtype), h


class SSDBlock(nn.Module):
    """One Mamba-2 block: the reference's `_init_block` params."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        d = cfg.d_model
        d_inner, H, P, N = _dims(cfg)
        conv_dim = d_inner + 2 * N
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.cfg = cfg
        self.ln = RMSNorm(d, eps=cfg.norm_eps, **kw)
        self.in_proj = Dense(d, 2 * d_inner + 2 * N + H, generator=generator,
                             **kw)
        self.conv_w = _param(normal_((cfg.ssm.conv_width, conv_dim), 0.1,
                                     generator=generator, **kw))
        self.conv_b = _param(torch.zeros((conv_dim,), **kw))
        self.A_log = _param(torch.zeros((H,), **f32))    # A = -exp(A_log)
        self.D = _param(torch.ones((H,), **f32))
        self.dt_bias = _param(torch.zeros((H,), **f32))
        self.out_proj = Dense(d_inner, d, generator=generator, **kw)
        self.ln_out = RMSNorm(d_inner, eps=cfg.norm_eps, **kw)

    def forward(self, x, conv_state=None, ssd_state=None):
        """The reference's `_block_apply`: x (B, S, d).  Streaming when a
        conv state is given: returns (out, (conv state, ssd state)); a
        prompt (S > 1, no ssd state) runs the chunked scan, a step the
        single-step recurrence from `ssd_state` (zeros when None).

        Under a mesh (DTensors) everything between the two projections
        runs on each rank's local batch rows (`meshctx.Local`): the split
        of in_proj's columns does not follow their shards over "model",
        and DTensor's strategy search over the scan's five-dimensional
        einsums takes minutes on a three-axis mesh.  The parameters used
        there are replicated by the plan."""
        from ..train.meshctx import Local, constrain_batch
        cfg = self.cfg
        d_inner, H, P, N = _dims(cfg)
        x = constrain_batch(x)
        residual = x
        blk = Local(self.in_proj(self.ln(x)))
        conv_w, conv_b, A_log, D, dt_bias, ln_scale = (
            blk.weight(p, {}) for p in (self.conv_w, self.conv_b,
                                         self.A_log, self.D, self.dt_bias,
                                         self.ln_out.scale))
        if conv_state is not None:
            conv_state = blk.local(conv_state)
        if ssd_state is not None:
            ssd_state = blk.local(ssd_state)
        z, xr, Bm, Cm, dt = torch.split(
            blk.x, [d_inner, d_inner, N, N, H], dim=-1)
        xbc = torch.cat([xr, Bm, Cm], dim=-1)
        if conv_state is None:
            xbc = _causal_conv(xbc, conv_w, conv_b)
            new_conv = None
        else:
            xbc, new_conv = _causal_conv(xbc, conv_w, conv_b,
                                         state=conv_state)
        xbc = silu(xbc)
        xr, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
        Bsz, S = xr.shape[:2]
        xh = xr.reshape(Bsz, S, H, P)
        dt = F.softplus(dt.float() + dt_bias)
        A = -torch.exp(A_log)
        if ssd_state is None and S > 1:
            y, hT = _ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm.chunk)
        else:
            h0 = ssd_state if ssd_state is not None else \
                torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                            device=x.device)
            # single-step recurrence (decode)
            dA = torch.exp(dt[:, 0] * A)                     # (B,H)
            xdt = xh[:, 0].float() * dt[:, 0][..., None]     # (B,H,P)
            hT = h0 * dA[..., None, None] + \
                xdt[..., None] * Bm[:, 0].float()[:, None, None, :]
            y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(),
                             hT)[:, None].to(xh.dtype)
        y = y + xh * D.to(xh.dtype)[:, None]
        y = y.reshape(Bsz, S, d_inner)
        y = rms_norm(y * silu(z), ln_scale, self.ln_out.eps)
        out = residual + self.out_proj(blk.wrap(y))
        if conv_state is None:
            return out
        return out, (blk.wrap(new_conv), blk.wrap(hT))


class Mamba2(LanguageModel):
    def __init__(self, cfg, *, device, generator=None):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"Mamba2 serves the ssm family, not "
                             f"{cfg.family!r}")
        dtype = DTYPES[cfg.param_dtype]
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.blocks = nn.ModuleList(SSDBlock(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.ln_f = RMSNorm(cfg.d_model, eps=cfg.norm_eps, device=device,
                            dtype=dtype)
        self.unembed = None if cfg.tie_embeddings else \
            Dense(cfg.d_model, cfg.padded_vocab, **kw)

    def forward(self, tokens, prefix_embeds=None, return_hidden: bool = False,
                cfg=None):
        """`cfg` (the model's own when None) may differ from it in `remat`
        and `remat_group` alone."""
        cfg = cfg or self.cfg
        x = self.embed_inputs(tokens, prefix_embeds)
        x = run_layers(list(self.blocks), x,
                       remat_groups(cfg.n_layers, cfg.remat_group),
                       self.remat(cfg))
        x = self.ln_f(x)
        aux = x.new_zeros((), dtype=torch.float32)
        if return_hidden:
            return x, aux
        return self.logits(x), aux


MODEL = Mamba2  # the family's model class


def init_params(seed, cfg, *, device=None) -> Mamba2:
    """The reference's `init_params(key, cfg)`: `seed` is an int or a
    `torch.Generator` on `device` (the card unless device="cpu"; "meta"
    allocates nothing)."""
    return build(Mamba2, seed, cfg, device)


def forward(params: Mamba2, tokens, cfg, prefix_embeds=None,
            return_hidden: bool = False, **_):
    """tokens (B, S) -> (logits (B, S_total, padded_vocab), 0.0)."""
    check_model(params, cfg)
    return params(tokens, prefix_embeds, return_hidden, cfg)


def loss_fn(params: Mamba2, batch, cfg, **_):
    """The chunked cross-entropy of the hidden states after the prefix
    (batch as `transformer.loss_fn` takes it)."""
    x, _ = forward(params, batch["tokens"], cfg,
                   prefix_embeds=batch.get("prefix_embeds"),
                   return_hidden=True)
    return params.loss_of_hidden(x, batch)


def init_state(cfg, batch: int, dtype, device=None) -> dict:
    d_inner, H, P, N = _dims(cfg)
    conv_dim = d_inner + 2 * N
    W = cfg.ssm.conv_width
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, W - 1, conv_dim),
                            dtype=dtype, device=dev),
        "ssd": torch.zeros((cfg.n_layers, batch, H, P, N),
                           dtype=torch.float32, device=dev),
    }


@serving
def prefill(params: Mamba2, tokens, cfg, cache_len: int = 0,
            prefix_embeds=None, **_):
    """Run the prompt; (last logits (B, 1, V), state).  cache_len is
    unused (the state is O(1)).  Each block streams from a zero conv
    state, so a one-token prompt takes the single-step branch.  On placed
    parameters the state is placed by the dry run's cache rule
    (`meshctx.place_cache`)."""
    from ..train.meshctx import place_cache, write
    check_model(params, cfg)
    x = params.embed_inputs(tokens, prefix_embeds)
    state = place_cache(init_state(cfg, x.shape[0], x.dtype,
                                   device=x.device), x)
    for i, bp in enumerate(params.blocks):
        x, (conv_s, ssd_s) = bp(x, conv_state=state["conv"][i])
        write(state["conv"], conv_s, layer=i)
        write(state["ssd"], ssd_s, layer=i)
    x = params.ln_f(x)
    return params.logits(x[:, -1:]), state


@serving
def decode_step(params: Mamba2, token, state: dict, pos: int, cfg):
    """One decode step; returns (logits (B, 1, V), state), the state
    written in place.  pos is unused (the state holds the history)."""
    from ..train.meshctx import write
    check_model(params, cfg)
    x = params.embed_inputs(token)
    for i, bp in enumerate(params.blocks):
        x, (conv_s, ssd_s) = bp(x, conv_state=state["conv"][i],
                                ssd_state=state["ssd"][i])
        write(state["conv"], conv_s, layer=i)
        write(state["ssd"], ssd_s, layer=i)
    return params.logits(params.ln_f(x)), state
