"""The LM stack's training on one device: AdamW, the train step, the
synthetic data pipeline, step-atomic checkpoints, int8 error-feedback
gradient compression and the resilience layer.  Port of `repro.train`;
imports torch and numpy only.  The sharding plan and the mesh context
come with the multi-card slice (ROADMAP queue 1)."""
from . import checkpoint, compression, data, optimizer, resilience
from .optimizer import AdamWConfig
from .train_step import (init_state, make_serve_fns, make_train_step,
                         state_shardings)

__all__ = ["checkpoint", "compression", "data", "optimizer", "resilience",
           "AdamWConfig", "init_state", "make_serve_fns", "make_train_step",
           "state_shardings"]
