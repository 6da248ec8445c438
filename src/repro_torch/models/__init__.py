"""The LM stack's serving half for all five families (dense, moe with the
VLM prefix, ssm, hybrid, encdec): configs schema, building blocks,
attention, MLP/MoE, the transformer, Mamba-2, the RG-LRU hybrid, the
encoder-decoder, the family dispatch and the reference-weights converter.
Port of `repro.models`; imports torch only."""
from . import (api, attention, common, config, convert, encdec, mamba2, mlp,
               rglru, transformer)
from .api import get_model
from .config import ArchConfig, MoEConfig, RecurrentConfig, SSMConfig

__all__ = ["api", "attention", "common", "config", "convert", "encdec",
           "mamba2", "mlp", "rglru", "transformer", "get_model", "ArchConfig",
           "MoEConfig", "RecurrentConfig", "SSMConfig"]
