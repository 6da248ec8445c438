"""The LM stack's training, on one device or on a (data, model) or
(pod, data, model) mesh: AdamW, the train step, the synthetic data
pipeline, step-atomic checkpoints, int8 error-feedback gradient
compression, the resilience layer, the sharding plan (`sharding`: the
reference's path rules as DTensor placements) and the mesh context of the
models' anchors (`meshctx`).  Port of `repro.train`; imports torch and
numpy only."""
from . import (checkpoint, compression, data, meshctx, optimizer, resilience,
               sharding)
from .optimizer import AdamWConfig
from .train_step import (batch_shardings, init_state, make_serve_fns,
                         make_train_step, place_batch, place_state,
                         state_shardings)

__all__ = ["checkpoint", "compression", "data", "meshctx", "optimizer",
           "resilience", "sharding", "AdamWConfig", "init_state",
           "make_serve_fns", "make_train_step", "state_shardings",
           "batch_shardings", "place_state", "place_batch"]
