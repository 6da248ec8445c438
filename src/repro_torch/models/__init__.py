"""The LM stack's serving half for the decoder-only families (dense, moe,
VLM prefix): configs schema, building blocks, attention, MLP/MoE, the
transformer, the family dispatch and the reference-weights converter.
Port of `repro.models`; imports torch only."""
from . import api, attention, common, config, convert, mlp, transformer
from .api import get_model
from .config import ArchConfig, MoEConfig, RecurrentConfig, SSMConfig

__all__ = ["api", "attention", "common", "config", "convert", "mlp",
           "transformer", "get_model", "ArchConfig", "MoEConfig",
           "RecurrentConfig", "SSMConfig"]
