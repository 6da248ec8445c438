"""Shared model building blocks, as torch modules.

Port of `repro.models.common`: `dense`, `rmsnorm`, `embed`, `rope`,
`gelu`, `silu`, and the training helpers `softmax_xent`,
`lm_loss_chunked` and the two-level remat of `scan_blocks_grouped`
(`remat_groups`, `run_layers`, over the port's layer lists with
`torch.utils.checkpoint`).

Conventions, as in the reference:
  * parameters are drawn from an explicit `torch.Generator` with the
    reference's distributions: a dense weight normal x 1/sqrt(d_in), an
    embedding normal x 0.02, a zero bias, a unit norm scale; each is drawn
    in float32 and cast to the parameter dtype (on the `meta` device
    nothing is drawn or allocated);
  * a dense weight keeps the reference's (d_in, d_out) orientation, so
    `y = x @ w` and `models.convert` copies weights without a transpose;
  * products accumulate in float32 and cast back to the activation dtype
    (torch's bf16 matmul accumulates in float32 and rounds its output
    once, where the reference rounds after its float32 bias add: in
    bfloat16 the bias add sees that one rounding more);
  * every module takes an explicit `device` and `dtype`; the entry points
    resolve theirs by the port's rule (`resolve_device`: the card unless
    the caller asks for the host, "meta" for shapes alone);
  * parameters are built frozen (`requires_grad=False`), so serving
    records no graph; `train.init_state` turns on the gradients of the
    model it trains;
  * under a mesh (`train.train_step.place_state`: DTensor parameters) the
    ops run on DTensors; the few that DTensor has no working rule for
    (the embedding lookup and the gold logit over a vocabulary that the
    model axis shards, the float32-output product of the bf16 loss
    logits) run on local blocks and say so where they do.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device

__all__ = ["DTYPES", "Dense", "RMSNorm", "Embedding", "LanguageModel",
           "build", "check_model", "on_device", "float32_product", "rope",
           "rms_norm", "serving",
           "gelu", "silu", "normal_", "softmax_xent", "lm_loss_chunked",
           "remat_groups", "run_layers", "recording"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def normal_(shape, scale: float, *, device, dtype, generator):
    """A parameter of `shape` drawn normal x `scale` in float32, cast to
    `dtype` (uninitialized on the meta device, and when `generator` is
    None: `models.convert` fills it)."""
    if device.type == "meta" or generator is None:
        return torch.empty(shape, device=device, dtype=dtype)
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """y = x @ w (+ b); w is (d_in, d_out)."""

    def __init__(self, d_in: int, d_out: int, *, device, dtype,
                 generator=None, bias: bool = False,
                 scale: float | None = None):
        super().__init__()
        scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
        self.w = _param(normal_((d_in, d_out), scale, device=device,
                                dtype=dtype, generator=generator))
        self.b = _param(torch.zeros((d_out,), device=device, dtype=dtype)) \
            if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _reduced(torch.matmul(x, self.w.to(x.dtype)))
        if self.b is not None:
            y = (y.float() + self.b.float()).to(x.dtype)
        return y


def _summed(t):
    """A DTensor's partial sums reduced (Partial -> Replicate); t itself
    when it has none."""
    from torch.distributed.tensor import Replicate
    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in t.placements))


class _Reduced(torch.autograd.Function):
    """y with its partial sums reduced, and so its gradient."""

    @staticmethod
    def forward(ctx, y):
        out = _summed(y)
        return out.view_as(out) if out is y else out

    @staticmethod
    def backward(ctx, g):
        return _summed(g)


def _reduced(y: torch.Tensor) -> torch.Tensor:
    """A product that DTensor leaves as a partial sum over some mesh
    dimensions (a row-parallel weight: the contraction is sharded)
    reduced there, where GSPMD reduces it: before the norm or the
    nonlinearity that reads it; and the gradient that comes back to it
    likewise.  DTensor would carry a partial sum on through the residual
    stream (forward or backward), and the next product, unable to take a
    partial operand with a weight sharded over the same mesh dimension,
    would gather that weight whole."""
    from torch.distributed.tensor import DTensor
    if not isinstance(y, DTensor) or y.device_mesh.size() == 1:
        return y
    return _Reduced.apply(y)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device, dtype, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = _param(torch.ones((d,), device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """RMSNorm of x over its last dim with `scale`, in float32, cast back
    to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype)


class Embedding(nn.Module):
    """Token table (vocab, d); tied models also unembed through it."""

    def __init__(self, vocab: int, d: int, *, device, dtype, generator=None):
        super().__init__()
        self.w = _param(normal_((vocab, d), 0.02, device=device, dtype=dtype,
                                generator=generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import DTensor
        if isinstance(self.w, DTensor):
            return _local_embedding(ids, self.w)
        return F.embedding(ids, self.w)


def _block(w, wp, xp):
    """w's local block under the placements wp, for a product with an
    activation whose rows (dim 0) are sharded as in xp: the block's
    gradient is a partial sum over the mesh dimensions that shard the
    rows."""
    from torch.distributed.tensor import Partial, Shard
    gp = tuple(Partial() if q == Shard(0) else p for p, q in zip(wp, xp))
    return w.redistribute(w.device_mesh, wp).to_local(grad_placements=gp)


def _gold(logits, labels):
    """logits[..., labels]: the gold logit of each position.  DTensor's
    rule for a gather along a dimension sharded over the vocabulary
    leaves a masked partial sum that breaks in the next op, so on
    DTensors the gather runs on local blocks (the rows' and the
    vocabulary's shards kept, any other placement replicated): each rank
    takes the labels that fall in its vocabulary block (zeros elsewhere)
    and the partial sums are reduced over the vocabulary's mesh
    dimension."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from ..train.meshctx import block_start
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    mesh, last = logits.device_mesh, logits.ndim - 1
    lp = tuple(p if p in (Shard(0), Shard(last)) else Replicate()
               for p in logits.placements)
    rp = tuple(Shard(0) if p == Shard(0) else Replicate() for p in lp)
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    ll = logits.redistribute(mesh, lp).to_local()
    lab = labels.redistribute(mesh, rp).to_local()
    lo = block_start(mesh, lp, last, ll.shape[-1])
    mine = (lab >= lo) & (lab < lo + ll.shape[-1])
    g = torch.gather(ll, -1, torch.where(mine, lab - lo, 0)[..., None]
                     )[..., 0] * mine
    gp = tuple(Partial() if p == Shard(last) else q for p, q in zip(lp, rp))
    g = DTensor.from_local(g, mesh, gp, run_check=False, shape=labels.shape,
                           stride=labels.stride())
    return g.redistribute(mesh, rp)


def _local_embedding(ids, w):
    """F.embedding(ids, w) of a DTensor table w (V, d).  DTensor's rule
    for a table sharded over the vocabulary leaves a masked partial sum
    whose mask breaks once the output is cast or concatenated, so the
    lookup runs on local blocks: the ids' rows keep their shards, w is
    gathered over the mesh dimensions that do not shard the vocabulary
    (the plan's FSDP gather), each rank looks up the ids that fall in its
    vocabulary rows (zeros elsewhere), and the partial sums are reduced
    over the vocabulary's mesh dimension."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from ..train.meshctx import block_start
    mesh = w.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    ip = tuple(p if p == Shard(0) else Replicate() for p in ids.placements)
    wp = tuple(Shard(0) if p == Shard(0) and q != Shard(0) else Replicate()
               for p, q in zip(w.placements, ip))
    il = ids.redistribute(mesh, ip).to_local()
    wl = _block(w, wp, ip)
    lo = block_start(mesh, wp, 0, wl.shape[0])
    mine = (il >= lo) & (il < lo + wl.shape[0])
    y = F.embedding(torch.where(mine, il - lo, 0), wl) \
        * mine[..., None].to(wl.dtype)
    yp = tuple(Shard(0) if q == Shard(0) else Partial() if p == Shard(0)
               else Replicate() for p, q in zip(wp, ip))
    shape = torch.Size(tuple(ids.shape) + (w.shape[1],))
    y = DTensor.from_local(y, mesh, yp, run_check=False, shape=shape,
                           stride=torch.empty(shape, device="meta").stride())
    return y.redistribute(mesh, ip)


class _Float32Product(torch.autograd.Function):
    """x2 (N, d) @ w.T for w (V, d) of a 16-bit dtype on the card: one
    product with a float32 output (which has no derivative of its own);
    the backward's two products in the operands' dtype, the incoming
    float32 gradient rounded to it first, as a 16-bit product's backward
    takes its gradient."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        return (torch.mm(g, w) if ctx.needs_input_grad[0] else None,
                torch.mm(g.t(), x2) if ctx.needs_input_grad[1] else None)


def _product(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x2.is_cuda:
        return _Float32Product.apply(x2, w)
    return torch.mm(x2.float(), w.float().t())


def _local_product(x2, w):
    """`_product` of two DTensors.  DTensor has no rule for the product
    with a float32 output (aten.mm.dtype), so it runs on local blocks: x2's
    rows keep their shards (its other placements are made replicated), and
    w's rows (the vocabulary) are sharded over every mesh dimension that
    does not shard x2's rows (w gathered over the others: the plan's FSDP
    gather), so each rank computes its rows' logits over its block of the
    vocabulary, the layout that the loss's anchor asks for (batch over
    the data axes, vocabulary over "model").  Where the vocabulary does
    not divide that many blocks, w keeps only the shards of its rows that
    it has on those mesh dimensions.  The float32 product is a DTensor
    sharded as those two."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x2.device_mesh
    xp = tuple(p if p == Shard(0) else Replicate() for p in x2.placements)
    ways = math.prod(mesh.size(md) for md, q in enumerate(xp)
                     if q != Shard(0))
    if w.shape[0] % ways == 0:
        wp = tuple(Replicate() if q == Shard(0) else Shard(0) for q in xp)
    else:
        wp = tuple(Shard(0) if p == Shard(0) and q != Shard(0)
                   else Replicate() for p, q in zip(w.placements, xp))
    yp = tuple(Shard(0) if q == Shard(0) else Shard(1) if p == Shard(0)
               else Replicate() for p, q in zip(wp, xp))
    y = _product(x2.redistribute(mesh, xp).to_local(),
                 _block(w, wp, xp))
    N, V = x2.shape[0], w.shape[0]
    return DTensor.from_local(y, mesh, yp, run_check=False,
                              shape=torch.Size((N, V)), stride=(V, 1))


def float32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T accumulated and returned in float32: on a card one product
    with a float32 output, on the host the product of the float32 copies
    (which hold the operands exactly); of DTensors, that product of their
    local blocks (`_local_product`)."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w.t())
    from torch.distributed.tensor import DTensor
    x2 = x.reshape(-1, x.shape[-1])
    y = _local_product(x2, w) if isinstance(x2, DTensor) else _product(x2, w)
    return y.reshape(*x.shape[:-1], w.shape[0])


def on_device(a, device) -> torch.Tensor:
    """A tensor, or a numpy array (copied: it may be read-only), on
    `device`."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device)


class LanguageModel(nn.Module):
    """What every family's model shares: the token table `embed`, the
    final norm `ln_f` and the unembedding `unembed` (None when tied), and
    the config `cfg` it was built for."""

    @property
    def device(self) -> torch.device:
        return self.embed.w.device

    def embed_inputs(self, tokens, prefix_embeds=None):
        """Token embeddings in the activation dtype, with the modality
        prefix (B, P, d) prepended."""
        adt = DTYPES[self.cfg.activation_dtype]
        x = self.embed(on_device(tokens, self.device).long()).to(adt)
        if prefix_embeds is not None:
            x = torch.cat([on_device(prefix_embeds, self.device).to(adt), x],
                          dim=1)
        return x

    def logits(self, x):
        """Float32 logits over `padded_vocab` of hidden states x.  Tied
        logits are the float32 product of x and the embedding table, as
        the reference's einsum with preferred_element_type=float32: in
        bfloat16 they are not rounded to bfloat16."""
        if self.unembed is None:
            return float32_product(x, self.embed.w.to(x.dtype))
        return self.unembed(x).float()

    def remat(self, cfg) -> bool:
        """Whether this forward rematerializes: `cfg.remat`, and a graph
        is being recorded for a trainable parameter (serving never
        checkpoints)."""
        return cfg.remat and torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())

    def loss_of_hidden(self, x, batch):
        """The reference's loss tail: the chunked cross-entropy of hidden
        states x (B, S_total, d) against `batch["labels"]` (B, S) under
        `batch.get("mask")`; the positions of a prefix (the VLM's) before
        the labels carry no loss.  Tied models unembed through the table."""
        labels = on_device(batch["labels"], self.device).long()
        mask = batch.get("mask")
        if mask is not None:
            mask = on_device(mask, self.device)
        P = x.shape[1] - labels.shape[1]
        if P > 0:
            x = x[:, P:]
        if self.unembed is None:
            return lm_loss_chunked(x, self.embed.w, labels, mask, tied=True)
        return lm_loss_chunked(x, self.unembed.w, labels, mask)


def build(cls, seed, cfg, device):
    """A family's `init_params(seed, cfg, device=...)`: the model `cls`
    drawn on `device` (the card unless device="cpu"; "meta" allocates
    nothing) from `seed`, an int or a `torch.Generator` on that device, so
    a full-width model is never staged through host memory."""
    dev = resolve_device(device)
    gen = seed
    if not isinstance(seed, torch.Generator) and dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    return cls(cfg, device=dev, generator=None if dev.type == "meta" else gen)


def check_model(params, cfg) -> None:
    """`params` must be built for `cfg`, up to the training-side knobs
    `remat` and `remat_group`, which change no parameter."""
    built = dataclasses.replace(params.cfg, remat=cfg.remat,
                                remat_group=cfg.remat_group)
    if built != cfg:
        raise ValueError(f"the model was built for {params.cfg.name!r}, "
                         f"not {cfg.name!r}")


def serving(fn):
    """A family's `prefill` or `decode_step`: under `torch.no_grad`, and
    on parameters placed on a mesh (`train_step.place_state`) with the
    plain tensors it makes (positions, masks, fresh states) counted as
    replicated, as the train step counts them."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with torch.no_grad(), implicit_replication():
            return fn(*args, **kwargs)
    return run


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding over the two halves of the head dim (not
    interleaved pairs).  x: (..., S, H, hd); positions: (..., S).  Angles
    in float32; each half cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, in float32."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    return (x32 * torch.sigmoid(x32)).to(x.dtype)


def recording(t: torch.Tensor) -> bool:
    """Whether an op on `t` now records a graph."""
    return torch.is_grad_enabled() and t.requires_grad


def softmax_xent(logits, labels, mask=None):
    """Mean token cross-entropy over the mask, in float32; logits
    (..., V), labels (...) integer."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _chunk_nll(x, w, labels, mask, tied: bool):
    """(sum of nll * mask, sum of mask) of one chunk; the logits over the
    whole padded vocabulary, accumulated in float32."""
    from ..train.meshctx import constrain_batch
    logits = float32_product(x, w.to(x.dtype) if tied else w.to(x.dtype).t())
    logits = constrain_batch(logits, 0, model_dim=2)      # (B, chunk, V)
    logz = torch.logsumexp(logits, dim=-1)
    gold = _gold(logits, labels)
    return ((logz - gold) * mask).sum(), mask.sum()


def lm_loss_chunked(x, w, labels, mask=None, tied: bool = False,
                    chunk: int = 512):
    """Cross-entropy over hidden states x (B, S, d) without forming the
    (B, S, V) logits: a loop over sequence chunks of `chunk`, each
    chunk's logits rematerialized in the backward pass (a checkpoint per
    chunk while a graph is recorded).  w: the unembedding (d, V), or the
    embedding table (V, d) when tied.  Positions padded onto the last
    chunk get mask 0."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    nc = -(-S // chunk)
    pad = nc * chunk - S
    mask = torch.ones((B, S), dtype=torch.float32, device=x.device) \
        if mask is None else mask.float()
    labels = labels.long()
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    from ..train.meshctx import constrain_batch
    x, labels, mask = (constrain_batch(t) for t in (x, labels, mask))
    remat = recording(x) or recording(w)
    tot = cnt = x.new_zeros((), dtype=torch.float32)
    for c in range(nc):
        part = (x[:, c * chunk:(c + 1) * chunk], w,
                labels[:, c * chunk:(c + 1) * chunk],
                mask[:, c * chunk:(c + 1) * chunk], tied)
        s, n = checkpoint(_chunk_nll, *part, use_reentrant=False) if remat \
            else _chunk_nll(*part)
        tot, cnt = tot + s, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def remat_groups(n_layers: int, group: int) -> list:
    """The reference's grouping rule for its two-level remat: layers in
    groups of `group` when it divides `n_layers`, else groups of one."""
    g = group if group and n_layers % group == 0 else 1
    return [list(range(i, i + g)) for i in range(0, n_layers, g)]


def run_layers(fns, carry, groups, remat: bool):
    """carry through `fns` (each carry -> carry) in order: the reference's
    `scan_blocks_grouped` over a layer list.  With `remat`, each group of
    `groups` (lists of indices into fns, in order) of more than one layer
    is checkpointed, and each layer in it too, so only a group's input is
    kept through the forward and a layer's internals live only while its
    backward runs; a group of one is a checkpointed layer.  Without it
    the layers run plainly."""
    if not remat:
        for f in fns:
            carry = f(carry)
        return carry

    def ckpt(fn, c):
        # a tuple carry's tensors go in as the checkpoint's own arguments:
        # an inner checkpoint saves its tensor arguments to the enclosing
        # one, but (torch 2.13) not a tensor inside a tuple, and then the
        # group's checkpoint never recomputes and each layer's checkpoint
        # keeps its own input alive: one level of remat, not two
        if isinstance(c, tuple):
            @functools.wraps(fn)
            def unpacked(*t):
                return fn(t)
            return checkpoint(unpacked, *c, use_reentrant=False)
        return checkpoint(fn, c, use_reentrant=False)

    def group(idx):
        def group_fn(c):
            for i in idx:
                c = ckpt(fns[i], c)
            return c
        return group_fn

    for idx in groups:
        carry = ckpt(fns[idx[0]] if len(idx) == 1 else group(idx), carry)
    return carry
