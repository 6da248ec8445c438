"""Shared model building blocks, as torch modules.

Port of `repro.models.common` (the serving half: `dense`, `rmsnorm`,
`embed`, `rope`, `gelu`, `silu`; the loss helpers come with training).

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
    the caller asks for the host, "meta" for shapes alone).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

__all__ = ["DTYPES", "Dense", "RMSNorm", "Embedding", "LanguageModel",
           "build", "check_model", "on_device", "float32_product", "rope",
           "gelu", "silu", "normal_"]

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
        y = torch.matmul(x, self.w.to(x.dtype))
        if self.b is not None:
            y = (y.float() + self.b.float()).to(x.dtype)
        return y


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device, dtype, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = _param(torch.ones((d,), device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps) * self.scale.float()
        return y.to(x.dtype)


class Embedding(nn.Module):
    """Token table (vocab, d); tied models also unembed through it."""

    def __init__(self, vocab: int, d: int, *, device, dtype, generator=None):
        super().__init__()
        self.w = _param(normal_((vocab, d), 0.02, device=device, dtype=dtype,
                                generator=generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.w)


def float32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T accumulated and returned in float32: on a card one product
    with a float32 output, on the host the product of the float32 copies
    (which hold the operands exactly)."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w.t())
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        y = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        y = torch.mm(x2.float(), w.float().t())
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
    if params.cfg != cfg:
        raise ValueError(f"the model was built for {params.cfg.name!r}, "
                         f"not {cfg.name!r}")


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
