"""The port's LM serving driver against the reference's, on the CPU.

`generate` (batched prefill, then greedy decode with the KV cache) on the
reduced float32 configs, with the reference's parameters carried over
(`models.convert.from_reference_params`) and prompts from a seeded numpy
generator:

* teacher-forced on the reference's own tokens (so that one near-tie
  cannot derail the comparison): every step's logits within 1e-4
  relative to scale of the reference's, and the greedy token equal
  wherever the reference's top-2 margin exceeds 10x that tolerance
  (times the logits' scale);
* the port's `generate` equals the reference's `generate` up to the
  first step whose margin is below that bound (all of them when none);
* the VLM prefix (internvl2-1b: the first decode position counts the
  prefix), the MoE (granite, llama4), a dense model (internlm2), the ssm
  (mamba2), the hybrid (recurrentgemma) and the encdec family (seamless,
  its source frames drawn after the prompt);
* `python -m repro_torch.launch.serve --device cpu` runs, for the ssm,
  hybrid and encdec families too, and without a card its default device
  raises.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.launch import serve
from repro_torch.models import convert, get_model, transformer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOGIT_RTOL = 1e-4
MARGIN = 10 * LOGIT_RTOL


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("arch", ["internvl2-1b", "granite-moe-1b-a400m",
                                  "llama4-scout-17b-a16e", "internlm2-1.8b",
                                  "mamba2-130m", "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_generate_matches_reference_teacher_forced(arch):
    import jax
    import jax.numpy as jnp
    from repro import configs as R
    from repro.launch.serve import generate as ref_generate
    from repro.models import get_model as ref_get_model
    cfg, rcfg = get_reduced(arch), R.get_reduced(arch)
    ref, M = ref_get_model(rcfg), get_model(cfg)
    p = jax.tree.map(np.asarray, ref.init_params(jax.random.PRNGKey(7),
                                                 rcfg))
    model = convert.from_reference_params(cfg, p, device="cpu")
    rng = np.random.default_rng(20)
    B, S, gen = 3, 10, 8
    tokens = rng.integers(0, cfg.vocab, (B, S))
    extra, rextra = {}, {}
    if cfg.family == "encdec":
        src = rng.standard_normal((B, S, cfg.d_model))
        extra = {"src_embeds": torch.as_tensor(src, dtype=torch.float32)}
        rextra = {"src_embeds": jnp.asarray(src, jnp.float32)}
    elif cfg.frontend != "none":
        pe = rng.standard_normal((B, cfg.frontend_positions, cfg.d_model))
        extra = {"prefix_embeds": torch.as_tensor(pe, dtype=torch.float32)}
        rextra = {"prefix_embeds": jnp.asarray(pe, jnp.float32)}
    cache_len = S + gen + 3
    ref_out = np.asarray(ref_generate(rcfg, p, jnp.asarray(tokens,
                                                           jnp.int32),
                                      gen, cache_len, rextra))
    # the reference's per-step logits along its own tokens
    rlog, rcache = ref.prefill(p, jnp.asarray(tokens, jnp.int32), rcfg,
                               cache_len=cache_len, **rextra)
    rlogits = [np.asarray(rlog[:, -1])]
    pos0 = S + (cfg.frontend_positions if cfg.frontend != "none" else 0)
    for i in range(gen - 1):
        rlog, rcache = ref.decode_step(p, jnp.asarray(ref_out[:, i:i + 1]),
                                       rcache, jnp.int32(pos0 + i), rcfg)
        rlogits.append(np.asarray(rlog[:, -1]))
    # the port, teacher-forced on the reference's tokens
    lg, cache = M.prefill(model, tokens, cfg, cache_len, **extra)
    logits = [lg[:, -1].numpy()]
    for i in range(gen - 1):
        lg, cache = M.decode_step(model, ref_out[:, i:i + 1], cache,
                                  pos0 + i, cfg)
        logits.append(lg[:, -1].numpy())
    first_tie = gen
    for i, (ours, theirs) in enumerate(zip(logits, rlogits)):
        assert _rel(ours, theirs) <= LOGIT_RTOL, i
        top2 = np.sort(theirs, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > MARGIN * max(
            1.0, np.abs(theirs).max())
        assert np.array_equal(ours.argmax(-1)[clear], ref_out[clear, i]), i
        if not clear.all():
            first_tie = min(first_tie, i)
    out = serve.generate(cfg, model, torch.as_tensor(tokens), gen,
                         cache_len, extra)
    assert out.shape == (B, gen)
    assert np.array_equal(out.numpy()[:, :first_tie],
                          ref_out[:, :first_tie])


def test_generate_runs_past_a_short_cache_ring():
    """cache_len shorter than prompt + generation: the ring wraps and the
    tokens stay in range (the reference's decode semantics)."""
    cfg = get_reduced("llama3-8b")
    model = transformer.init_params(3, cfg, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(21).integers(
        0, cfg.vocab, (2, 12)))
    out = serve.generate(cfg, model, tokens, 10, cache_len=8)
    assert out.shape == (2, 10)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.padded_vocab


def test_serve_cli_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-moe-1b-a400m", "--batch", "2", "--prompt-len", "8",
         "--gen", "4", "--device", "cpu"], capture_output=True, text=True,
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin",
                       "OMP_NUM_THREADS": "1"}, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "generated (2, 4)" in proc.stdout


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "mamba2-130m",
                                  "recurrentgemma-9b"])
def test_serve_main_serves_the_recurrent_and_encdec_families(arch):
    """`main` on the CPU for the ssm, hybrid and encdec families (encdec
    with its source frames drawn after the tokens); the tokens lie in the
    padded vocabulary."""
    out = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "6",
                      "--gen", "4", "--device", "cpu"])
    assert tuple(out.shape) == (2, 4)
    cfg = get_reduced(arch)
    assert 0 <= int(out.min()) and int(out.max()) < cfg.padded_vocab


def test_serve_main_keeps_the_reference_flags():
    """`--reduced` is store_true with default True (ROADMAP R7: it cannot
    be turned off), as in the reference; main returns the tokens."""
    out = serve.main(["--arch", "internvl2-1b", "--batch", "1",
                      "--prompt-len", "5", "--gen", "3", "--device", "cpu"])
    assert tuple(out.shape) == (1, 3)


@pytest.mark.cuda
def test_cuda_generate_matches_the_cpu_generate():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = get_reduced("internvl2-1b")
    cpu = transformer.init_params(4, cfg, device="cpu")
    card = transformer.init_params(4, cfg, device="cpu").to("cuda")
    rng = np.random.default_rng(22)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 9)))
    pe = torch.as_tensor(rng.standard_normal(
        (2, cfg.frontend_positions, cfg.d_model)), dtype=torch.float32)
    lc, _ = transformer.prefill(cpu, tokens, cfg, 16, prefix_embeds=pe)
    lg, _ = transformer.prefill(card, tokens.cuda(), cfg, 16,
                                prefix_embeds=pe.cuda())
    assert _rel(lg.cpu(), lc) <= LOGIT_RTOL
    out = serve.generate(cfg, card, tokens.cuda(), 6, 16,
                         {"prefix_embeds": pe.cuda()})
    assert out.device.type == "cuda" and out.shape == (2, 6)
