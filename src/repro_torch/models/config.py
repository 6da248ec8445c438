"""Architecture configuration schema.

Copy of `repro.models.config` (which imports no JAX, but the port imports
nothing of the JAX package).  One dataclass covers all 10 assigned
families (dense / MoE / SSM / hybrid / enc-dec / VLM+audio backbones).
Exact per-arch values live in repro_torch.configs.<arch>; every config
there also provides a reduced smoke-test variant via `reduced()`.
`tests/test_torch_lm_configs.py` holds every config, `params_count` and
`active_params_count` equal to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "RecurrentConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # dense fallback MLP interleaving (llama4 uses shared expert + moe)
    shared_expert: bool = False
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128          # N
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    chunk: int = 256              # SSD chunk length
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    lru_width: int = 0            # 0 => d_model
    window: int = 2048            # local attention window
    pattern: tuple[str, ...] = ("rec", "rec", "attn")  # 1:2 attn:rec


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 => d_model // n_heads
    vocab_pad_to: int = 256       # pad vocab so logits shard cleanly
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    act: Literal["silu", "gelu"] = "silu"   # SwiGLU vs GeGLU gate
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    recurrent: RecurrentConfig | None = None
    # enc-dec only
    n_layers_decoder: int = 0
    # modality frontend stub: number of prefix embedding positions fed by
    # input_specs() (vlm: patch embeddings, audio: frame embeddings)
    frontend: Literal["none", "vlm", "audio"] = "none"
    frontend_positions: int = 0
    # attention flavour
    attention: Literal["full", "local", "none"] = "full"
    window: int = 0
    # numerics
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    # training-side defaults
    remat: bool = True
    remat_group: int = 4          # two-level remat: layers per saved group
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return -(-self.vocab // m) * m

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports 500k-token decode (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def params_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND."""
        d, v = self.d_model, self.padded_vocab
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            from .mamba2 import ssd_params_per_layer
            blk = ssd_params_per_layer(self)
            return emb + self.n_layers * blk
        att = d * (self.n_heads * hd) + d * (2 * self.n_kv * hd) \
            + (self.n_heads * hd) * d
        mlp = 3 * d * self.d_ff
        if self.family == "moe":
            mlp = self.moe.num_experts * 3 * d * self.moe.d_ff_expert
            if self.moe.shared_expert:
                mlp += 3 * d * self.d_ff
        per = att + mlp
        if self.family == "hybrid":
            # mix of RG-LRU blocks and attention blocks
            w = self.recurrent.lru_width or d
            rec = d * 2 * w + w * d + 3 * w  # in/out proj + gates (approx)
            att_layers = sum(1 for i in range(self.n_layers)
                             if self.recurrent.pattern[
                                 i % len(self.recurrent.pattern)] == "attn")
            rec_layers = self.n_layers - att_layers
            return emb + att_layers * (att + mlp) + rec_layers * (rec + mlp)
        total_layers = self.n_layers + self.n_layers_decoder
        if self.family == "encdec":
            # decoder layers add cross-attention
            return emb + self.n_layers * per + self.n_layers_decoder * (per + att)
        return emb + total_layers * per

    def active_params_count(self) -> int:
        """Active (per-token) params — differs from total for MoE."""
        if self.family != "moe":
            return self.params_count()
        d, v = self.d_model, self.padded_vocab
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        att = d * (self.n_heads * hd) + d * (2 * self.n_kv * hd) \
            + (self.n_heads * hd) * d
        mlp = self.moe.top_k * 3 * d * self.moe.d_ff_expert
        if self.moe.shared_expert:
            mlp += 3 * d * self.d_ff
        return emb + self.n_layers * (att + mlp)
