"""Serving driver: batched prefill + greedy decode with a KV cache (or the
recurrent state), for every family.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --batch 4 --prompt-len 32 --gen 16 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch seamless-m4t-large-v2 --device cpu

Port of `repro.launch.serve`.  Decode runs eagerly, one step at a time
(no `torch.compile`, no CUDA graph).  The flags are the reference's, and
`--device` (default cuda: without a card it raises).  `--reduced` is kept
as the reference has it, `store_true` with `default=True`, so it cannot be
turned off and `main` always serves the reduced config (reference fault
R7 in ROADMAP.md); `generate` serves any config it is given.  For the
encdec family `main` draws frame embeddings (B, prompt-len, d) for the
encoder after the tokens, from the same generator, as the reference does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_reduced
from ..device import resolve_device
from ..models.api import get_model


@torch.no_grad()
def generate(cfg, params, tokens, gen_steps: int, cache_len: int,
             extra: dict | None = None) -> torch.Tensor:
    """Greedy generation: prefill `tokens` (B, S), then `gen_steps - 1`
    decode steps; (B, gen_steps) token ids (int64) on the model's device.
    The argmax runs over the padded vocabulary, as the reference's does;
    `extra` carries `prefix_embeds` for the VLM prefix, whose positions
    come before the prompt's, or `src_embeds` (B, S_src, d) for the
    encdec family's encoder."""
    model = get_model(cfg)
    extra = extra or {}
    logits, cache = model.prefill(params, tokens, cfg, cache_len=cache_len,
                                  **extra)
    out = [logits[:, -1:].argmax(dim=-1)]
    pos = tokens.shape[1] + (cfg.frontend_positions
                             if cfg.frontend != "none" else 0)
    for i in range(gen_steps - 1):
        logits, cache = model.decode_step(params, out[-1], cache, pos + i,
                                          cfg)
        out.append(logits[:, -1:].argmax(dim=-1))
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = get_model(cfg)
    rng = np.random.default_rng(args.seed)
    params = model.init_params(args.seed, cfg, device=dev)
    B, S = args.batch, args.prompt_len
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=dev)
    extra = {}
    if cfg.family == "encdec":
        extra["src_embeds"] = torch.as_tensor(
            rng.standard_normal((B, S, cfg.d_model)), dtype=torch.float32,
            device=dev)
    elif cfg.frontend != "none":
        extra["prefix_embeds"] = torch.as_tensor(
            rng.standard_normal((B, cfg.frontend_positions, cfg.d_model)),
            dtype=torch.float32, device=dev)
    cache_len = S + args.gen + 8
    t0 = time.time()
    out = generate(cfg, params, tokens, args.gen, cache_len, extra)
    dt = time.time() - t0
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({B * args.gen / dt:.1f} tok/s, eager)")
    print("sample:", out[0][:12].cpu().numpy())
    return out


if __name__ == "__main__":
    main()
