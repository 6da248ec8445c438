"""The port's decoder-only LM modules against the reference's, on the CPU.

The same parameters (the reference's `init_*` draws, carried into the
port's modules through numpy: `models.convert.from_reference_params` for
whole models) and the same inputs (a seeded numpy generator) go through
both packages, in float32 (the reduced configs).  Tolerances:

* building blocks (`rmsnorm`, `rope`, `dense` with a bias, `gelu`,
  `silu`), `_chunked_attn` (GQA, padded q and kv chunks, causal, a
  sliding window, a q offset, non-causal MQA), self- and
  cross-attention, `decode_attention` on a ring past `cache_len`, and
  the MoE layer: 1e-5 relative to the reference output's scale
  (max |ref|, at least 1);
* whole models (`forward`, `prefill` logits and cache, `decode_step`) on
  the seven reduced decoder-only configs: 1e-4 relative to scale;
* prefill plus one decode step against `forward` on the prompt plus that
  token, within the port alone (as `tests/test_models.py` holds the
  reference): 1e-4 relative to scale.

The MoE's selected experts and keep mask are equal, including a case
where `capacity_factor` is lowered (by `dataclasses.replace`, in both
packages) until picks drop.  The reference is imported inside the tests
and helpers that use it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import convert, get_model, transformer
from repro_torch.models.mlp import MoE

torch.set_num_threads(1)

DECODER_ARCHS = ["internvl2-1b", "gemma-7b", "internlm2-1.8b", "llama3-8b",
                 "qwen2-7b", "llama4-scout-17b-a16e", "granite-moe-1b-a400m"]
BLOCK_RTOL = 1e-5
MODEL_RTOL = 1e-4
CPU = torch.device("cpu")


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    assert x.shape == ref.shape, (x.shape, ref.shape)
    return np.abs(x - ref).max() / max(1.0, np.abs(ref).max())


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _load(module, ref_tree):
    """Copy a reference params dict into `module` by parameter name."""
    ours = dict(module.named_parameters())
    theirs = dict(convert._flatten(_np(ref_tree)))
    assert set(ours) == set(theirs), (sorted(ours), sorted(theirs))
    with torch.no_grad():
        for k, p in ours.items():
            p.copy_(torch.as_tensor(np.array(theirs[k])))
    return module


def _ref_params(cfg, seed=1):
    import jax
    from repro.models import get_model as ref_get_model
    return _np(ref_get_model(_ref_cfg(cfg)).init_params(
        jax.random.PRNGKey(seed), _ref_cfg(cfg)))


def _ref_cfg(cfg):
    """The reference's ArchConfig with cfg's fields."""
    from repro.models import config as RC
    d = dataclasses.asdict(cfg)
    if d["moe"] is not None:
        d["moe"] = RC.MoEConfig(**d["moe"])
    for key, cls in (("ssm", RC.SSMConfig), ("recurrent", RC.RecurrentConfig)):
        if d[key] is not None:
            d[key] = cls(**d[key])
    return RC.ArchConfig(**d)


# -- building blocks ----------------------------------------------------------


@pytest.mark.parametrize("block", ["rmsnorm", "rope", "dense_bias", "gelu",
                                   "silu"])
def test_building_block_matches_reference(block):
    import jax
    import jax.numpy as jnp
    from repro.models import common as RC
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    if block == "rmsnorm":
        p = {"scale": rng.standard_normal(16).astype(np.float32)}
        mod = C.RMSNorm(16, device=CPU, dtype=torch.float32, eps=1e-5)
        _load(mod, p)
        got = mod(_t(x))
        ref = RC.rmsnorm(p, jnp.asarray(x), 1e-5)
    elif block == "rope":
        pos = rng.integers(0, 300, (2, 7))
        got = C.rope(_t(x), torch.as_tensor(pos), 500000.0)
        ref = RC.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    elif block == "dense_bias":
        p = RC.init_dense(jax.random.PRNGKey(0), 16, 24, jnp.float32,
                          bias=True)
        p["b"] = jnp.asarray(rng.standard_normal(24), jnp.float32)
        mod = _load(C.Dense(16, 24, bias=True, device=CPU,
                            dtype=torch.float32), p)
        got = mod(_t(x))
        ref = RC.dense(p, jnp.asarray(x))
    else:
        got = getattr(C, block)(_t(x))
        ref = getattr(RC, block)(jnp.asarray(x))
    assert got.dtype == torch.float32
    assert _rel(got, ref) <= BLOCK_RTOL


def test_dense_init_draws_the_reference_distribution():
    """Normal x 1/sqrt(d_in), zero bias; embeddings x 0.02; unit scale."""
    g = torch.Generator().manual_seed(0)
    d = C.Dense(256, 512, bias=True, device=CPU, dtype=torch.float32,
                generator=g)
    assert abs(d.w.std().item() * 16 - 1) < 0.02
    assert torch.count_nonzero(d.b) == 0
    e = C.Embedding(512, 256, device=CPU, dtype=torch.float32, generator=g)
    assert abs(e.w.std().item() / 0.02 - 1) < 0.02
    assert torch.equal(C.RMSNorm(8, device=CPU, dtype=torch.bfloat16).scale,
                       torch.ones(8, dtype=torch.bfloat16))


# -- attention ----------------------------------------------------------------

ATTN_CASES = {
    # name: (Sq, Sk, H, K, causal, window, q_offset)
    "gqa_causal_padded": (19, 19, 4, 2, True, 0, 0),
    "local_window": (19, 19, 4, 2, True, 5, 0),
    "q_offset": (7, 19, 4, 2, True, 0, 12),
    "noncausal_mqa": (11, 17, 4, 1, False, 0, 0),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attn_matches_reference(case):
    """Chunks of 8 over q and kv (19 and 17 are not multiples of it)."""
    import jax.numpy as jnp
    from repro.models.attention import _chunked_attn as ref_attn
    Sq, Sk, H, K, causal, window, q_offset = ATTN_CASES[case]
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, Sq, H, 8)).astype(np.float32)
    k = rng.standard_normal((2, Sk, K, 8)).astype(np.float32)
    v = rng.standard_normal((2, Sk, K, 8)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_chunk=8,
              q_chunk=8)
    got = A._chunked_attn(_t(q), _t(k), _t(v), **kw)
    ref = ref_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    assert np.isfinite(got.numpy()).all()
    assert _rel(got, ref) <= BLOCK_RTOL


def _attention_pair(cfg, seed=3):
    import jax
    import jax.numpy as jnp
    from repro.models.attention import init_attention
    p = init_attention(jax.random.PRNGKey(seed), _ref_cfg(cfg), jnp.float32)
    if cfg.qkv_bias:    # zero at init: give the biases values to compare
        rng = np.random.default_rng(seed)
        for name in ("q", "k", "v"):
            p[name]["b"] = jnp.asarray(
                rng.standard_normal(p[name]["b"].shape), jnp.float32)
    return _load(A.Attention(cfg, device=CPU, dtype=torch.float32), p), p


@pytest.mark.parametrize("arch,local", [("qwen2-7b", False),
                                        ("llama3-8b", False),
                                        ("internlm2-1.8b", True)])
def test_self_attention_with_cache_matches_reference(arch, local):
    """y and the roped (k, v) that prefill caches; qwen2 with its QKV bias,
    llama3 with 8 heads on 2 kv heads, internlm2 with a sliding window."""
    import jax.numpy as jnp
    from repro.models.attention import attention as ref_attention
    cfg = get_reduced(arch)
    if local:
        cfg = dataclasses.replace(cfg, attention="local", window=6)
    mod, p = _attention_pair(cfg)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    pos = np.arange(21)[None, :]
    y, (k, v) = mod(_t(x), torch.as_tensor(pos), kv_chunk=8,
                    with_cache=True)
    ry, (rk, rv) = ref_attention(p, jnp.asarray(x), jnp.asarray(pos),
                                 _ref_cfg(cfg), kv_chunk=8, with_cache=True)
    for got, ref in ((y, ry), (k, rk), (v, rv)):
        assert _rel(got, ref) <= BLOCK_RTOL


def test_cross_attention_matches_reference():
    import jax.numpy as jnp
    from repro.models.attention import attention as ref_attention
    cfg = get_reduced("llama3-8b")
    mod, p = _attention_pair(cfg)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 14, cfg.d_model)).astype(np.float32)
    pos = np.arange(9)[None, :]
    y = mod(_t(x), torch.as_tensor(pos), kv_source=_t(src), causal=False,
            kv_chunk=8)
    ry = ref_attention(p, jnp.asarray(x), jnp.asarray(pos), _ref_cfg(cfg),
                       kv_source=jnp.asarray(src), causal=False, kv_chunk=8)
    assert _rel(y, ry) <= BLOCK_RTOL


@pytest.mark.parametrize("local", [False, True])
def test_decode_attention_on_a_ring_matches_reference(local):
    """Decode steps at positions past cache_len: the ring slot written
    and the valid mask (`_ring_valid`), full and sliding-window."""
    import jax.numpy as jnp
    from repro.models.attention import decode_attention
    cfg = get_reduced("internlm2-1.8b")
    if local:
        cfg = dataclasses.replace(cfg, attention="local", window=5)
    mod, p = _attention_pair(cfg)
    rng = np.random.default_rng(14)
    hd = cfg.resolved_head_dim
    S_cache = 8
    ck = rng.standard_normal((2, S_cache, cfg.n_kv, hd)).astype(np.float32)
    cv = rng.standard_normal((2, S_cache, cfg.n_kv, hd)).astype(np.float32)
    tk, tv = _t(ck), _t(cv)
    rk, rv = jnp.asarray(ck), jnp.asarray(cv)
    for pos in (3, 8, 13, 21):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        y, tk, tv = mod.decode(_t(x), tk, tv, pos)
        ry, rk, rv = decode_attention(p, jnp.asarray(x), rk, rv,
                                      jnp.int32(pos), _ref_cfg(cfg))
        assert _rel(y, ry) <= BLOCK_RTOL, pos
        assert _rel(tk, rk) <= BLOCK_RTOL and _rel(tv, rv) <= BLOCK_RTOL


def test_ring_valid_matches_reference():
    import jax.numpy as jnp
    from repro.models.attention import _ring_valid as ref_ring
    slots = np.arange(8)
    for pos in (0, 5, 7, 8, 19):
        for window in (0, 3):
            got = A._ring_valid(torch.as_tensor(slots), pos, 8, window)
            ref = ref_ring(jnp.asarray(slots), pos, 8, window)
            assert np.array_equal(got.numpy(), np.asarray(ref))


# -- MoE ----------------------------------------------------------------------


def _ref_routing(p, x, cfg):
    """The reference's selected experts and keep mask, recomputed from its
    router with the lines of `repro.models.mlp.moe`."""
    import jax
    import jax.numpy as jnp
    from repro.models.common import dense
    mo = cfg.moe
    G, Tg, _ = x.shape
    E, k = mo.num_experts, mo.top_k
    probs = jax.nn.softmax(dense(p["router"], x).astype(jnp.float32), -1)
    _, sel = jax.lax.top_k(probs, k)
    cap = max(1, -(-int(mo.capacity_factor * Tg * k) // E))
    sel_flat = sel.reshape(G, Tg * k)
    one_hot_e = jax.nn.one_hot(sel_flat, E, dtype=jnp.int32)
    pos_in_e = jnp.cumsum(one_hot_e, axis=1) - one_hot_e
    pos = jnp.take_along_axis(pos_in_e, sel_flat[..., None], axis=2)[..., 0]
    return np.asarray(sel), np.asarray((pos < cap).reshape(G, Tg, k))


@pytest.mark.parametrize("arch,capacity_factor", [
    ("granite-moe-1b-a400m", None), ("llama4-scout-17b-a16e", None),
    ("granite-moe-1b-a400m", 0.5), ("llama4-scout-17b-a16e", 0.5)])
def test_moe_matches_reference(arch, capacity_factor):
    """Selected experts, keep mask, y and the aux loss; with a lowered
    capacity factor some picks drop (keep holds a False)."""
    import jax
    import jax.numpy as jnp
    from repro.models.mlp import init_moe, moe
    cfg = get_reduced(arch)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    rcfg = _ref_cfg(cfg)
    p = init_moe(jax.random.PRNGKey(4), rcfg, jnp.float32)
    mod = _load(MoE(cfg, device=CPU, dtype=torch.float32), p)
    x = np.random.default_rng(15).standard_normal(
        (3, 16, cfg.d_model)).astype(np.float32)
    _, sel, _, keep, _, _ = mod.route(_t(x))
    rsel, rkeep = _ref_routing(p, jnp.asarray(x), rcfg)
    assert np.array_equal(sel.numpy(), rsel)
    assert np.array_equal(keep.numpy(), rkeep)
    if capacity_factor is not None:
        assert not rkeep.all()
    y, aux = mod(_t(x), cfg.act)
    ry, raux = moe(p, jnp.asarray(x), rcfg, cfg.act)
    assert _rel(y, ry) <= BLOCK_RTOL
    assert abs(float(aux) - float(raux)) <= \
        BLOCK_RTOL * max(1, abs(float(raux)))


def test_moe_top_k_ties_take_the_lower_expert():
    """Equal router probabilities pick experts in index order, as
    `lax.top_k` does."""
    cfg = get_reduced("granite-moe-1b-a400m")
    mod = MoE(cfg, device=CPU, dtype=torch.float32)
    with torch.no_grad():
        mod.router.w.zero_()
    _, sel, gates, keep, _, _ = mod.route(torch.ones((1, 3, cfg.d_model)))
    assert sel.tolist() == [[[0, 1], [0, 1], [0, 1]]]
    # cap = max(1, ceil(int(1.25 * 3 * 2) / 8)) = 1: the first token's
    # picks fill experts 0 and 1, the later tokens' drop
    assert keep.tolist() == [[[True, True], [False, False], [False, False]]]
    assert gates[0, 0].tolist() == [0.5, 0.5]
    assert torch.count_nonzero(gates[0, 1:]) == 0


# -- whole models -------------------------------------------------------------


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    prefix = None
    if cfg.frontend != "none":
        prefix = rng.standard_normal(
            (B, cfg.frontend_positions, cfg.d_model)).astype(np.float32)
    return tokens, prefix


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_model_matches_reference(arch):
    """forward, prefill (last logits and the whole cache) and two decode
    steps, one past the prompt's ring (cache_len < prompt + steps)."""
    import jax.numpy as jnp
    from repro.models import get_model as ref_get_model
    cfg = get_reduced(arch)
    rcfg = _ref_cfg(cfg)
    ref = ref_get_model(rcfg)
    p = _ref_params(cfg)
    model = convert.from_reference_params(cfg, p, device="cpu")
    B, S = 2, 11
    tokens, prefix = _inputs(cfg, B, S, seed=16)
    kw = {} if prefix is None else {"prefix_embeds": prefix}
    rkw = {k: jnp.asarray(v) for k, v in kw.items()}
    logits, aux = transformer.forward(model, tokens, cfg, **kw)
    rlogits, raux = ref.forward(p, jnp.asarray(tokens, jnp.int32), rcfg,
                                **rkw)
    assert logits.shape == (B, S + (cfg.frontend_positions
                                    if prefix is not None else 0),
                            cfg.padded_vocab)
    assert _rel(logits, rlogits) <= MODEL_RTOL
    assert abs(float(aux) - float(raux)) <= MODEL_RTOL * max(1, float(raux))
    S_tot = logits.shape[1]
    cache_len = S_tot + 1
    lp, cache = transformer.prefill(model, tokens, cfg, cache_len, **kw)
    rlp, rcache = ref.prefill(p, jnp.asarray(tokens, jnp.int32), rcfg,
                              cache_len=cache_len, **rkw)
    assert _rel(lp, rlp) <= MODEL_RTOL
    for key in ("k", "v"):
        assert cache[key].shape == rcache[key].shape
        assert _rel(cache[key], rcache[key]) <= MODEL_RTOL
    nxt = np.random.default_rng(17).integers(0, cfg.vocab, (B, 2))
    for i in range(2):   # the second step wraps the ring (slot 0)
        ld, cache = transformer.decode_step(model, nxt[:, i:i + 1], cache,
                                            S_tot + i, cfg)
        rld, rcache = ref.decode_step(p, jnp.asarray(nxt[:, i:i + 1],
                                                     jnp.int32),
                                      rcache, jnp.int32(S_tot + i), rcfg)
        assert _rel(ld, rld) <= MODEL_RTOL, i
        assert _rel(cache["k"], rcache["k"]) <= MODEL_RTOL, i


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma-7b"])
def test_prefill_decode_matches_forward(arch):
    """prefill(prompt) + decode_step == forward(prompt + token), the
    port's own parameters (tests/test_models.py's check)."""
    cfg = get_reduced(arch)
    model = transformer.init_params(1, cfg, device="cpu")
    B, S = 2, 12
    toks = np.random.default_rng(18).integers(2, cfg.vocab, (B, S + 1))
    prompt, nxt = toks[:, :S], toks[:, S:]
    lp, cache = transformer.prefill(model, prompt, cfg, cache_len=S + 4)
    ld, _ = transformer.decode_step(model, nxt, cache, S, cfg)
    full, _ = transformer.forward(model, toks, cfg)
    assert _rel(ld[:, 0], full[:, -1].detach()) <= MODEL_RTOL
    assert _rel(lp[:, -1], full[:, S - 1].detach()) <= MODEL_RTOL


@pytest.mark.parametrize("arch", ["internvl2-1b", "granite-moe-1b-a400m"])
def test_tied_logits_in_bfloat16_are_the_reference_float32_product(arch):
    """A tied model in bfloat16: the logits of bfloat16 hidden states are
    the reference's float32 product with the bfloat16 table (einsum with
    preferred_element_type=float32), within 1e-5 relative to scale; a
    product rounded to bfloat16 is off by about 2**-9."""
    import jax.numpy as jnp
    cfg = dataclasses.replace(get_reduced(arch), param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    assert cfg.tie_embeddings
    model = transformer.init_params(4, cfg, device="cpu")
    x = _t(np.random.default_rng(20).standard_normal((2, 5, cfg.d_model)),
           torch.bfloat16)
    got = model.logits(x)
    assert got.dtype == torch.float32
    w = model.embed.w
    ref = jnp.einsum("bsd,vd->bsv", jnp.asarray(x.float().numpy(),
                                                jnp.bfloat16),
                     jnp.asarray(w.float().numpy(), jnp.bfloat16),
                     preferred_element_type=jnp.float32)
    assert _rel(got, ref) <= BLOCK_RTOL


def test_convert_raises_on_a_mismatched_tree():
    cfg = get_reduced("qwen2-7b")
    p = _ref_params(cfg)
    bad = dict(p, ln_f={})
    with pytest.raises(ValueError, match="missing"):
        convert.from_reference_params(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        convert.from_reference_params(
            cfg, dict(p, unembed=p["unembed"], extra={"w": p["ln_f"]
                                                      ["scale"]}),
            device="cpu")
    wide = dict(p, ln_f={"scale": np.ones(cfg.d_model + 1, np.float32)})
    with pytest.raises(ValueError, match="shapes"):
        convert.from_reference_params(cfg, wide, device="cpu")


def test_convert_keeps_tied_embeddings_and_the_dense_orientation():
    cfg = get_reduced("gemma-7b")
    p = _ref_params(cfg)
    model = convert.from_reference_params(cfg, p, device="cpu")
    assert model.unembed is None and "unembed" not in p
    assert np.array_equal(model.blocks[1].attn.q.w.numpy(),
                          p["blocks"]["attn"]["q"]["w"][1])
    assert np.array_equal(model.embed.w.numpy(), p["embed"]["w"])


# -- dispatch, no fallback ---------------------------------------------------


@pytest.mark.parametrize("family,arch,module", [
    ("dense", "llama3-8b", "transformer"),
    ("moe", "granite-moe-1b-a400m", "transformer"),
    ("ssm", "mamba2-130m", "mamba2"),
    ("hybrid", "recurrentgemma-9b", "rglru"),
    ("encdec", "seamless-m4t-large-v2", "encdec"),
    ("unknown", "llama3-8b", None)])
def test_get_model_serves_each_family(family, arch, module):
    """Each family's module, as the reference's dispatch; an unknown
    family raises KeyError (there is no stand-in)."""
    import repro_torch.models as models
    cfg = get_reduced(arch)
    assert cfg.family == family or module is None
    if module is None:
        with pytest.raises(KeyError):
            get_model(dataclasses.replace(cfg, family=family))
        return
    M = get_model(cfg)
    assert M is getattr(models, module)
    assert type(M.init_params(0, cfg, device="meta")) is M.MODEL


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.from_reference_params(cfg, {}, device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_cache(cfg, 1, 4, torch.float32)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="not available"):
        serve.main(["--arch", "internlm2-1.8b"])
    assert transformer.init_params(0, cfg, device="cpu").device == CPU


def test_full_config_on_meta_allocates_nothing():
    cfg = get_config("llama4-scout-17b-a16e")
    model = transformer.init_params(0, cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert all(p.is_meta for p in model.parameters())
    assert n == cfg.params_count() + cfg.n_layers * (
        2 * cfg.d_model + cfg.d_model * cfg.moe.num_experts) + cfg.d_model


@pytest.mark.cuda
def test_cuda_model_matches_the_cpu_model():
    """The same parameters on the card and on the host: prefill and decode
    within 1e-4 relative to scale (the card's float32 matmuls)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = get_reduced("granite-moe-1b-a400m")
    cpu = transformer.init_params(5, cfg, device="cpu")
    card = transformer.init_params(5, cfg, device="cpu").to("cuda")
    tokens, _ = _inputs(cfg, 2, 9, seed=19)
    lp, cache = transformer.prefill(cpu, tokens, cfg, 12)
    lpc, cachec = transformer.prefill(card, tokens, cfg, 12)
    assert _rel(lpc.cpu(), lp) <= MODEL_RTOL
    ld, _ = transformer.decode_step(cpu, tokens[:, :1], cache, 9, cfg)
    ldc, _ = transformer.decode_step(card, tokens[:, :1], cachec, 9, cfg)
    assert _rel(ldc.cpu(), ld) <= MODEL_RTOL


@pytest.mark.cuda
def test_cuda_tied_logits_in_bfloat16_are_float32():
    """On the card, a bfloat16 tied model's logits are the float32
    product of the bfloat16 operands: within 1e-5 relative to scale of
    the host's product of their float32 copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dataclasses.replace(get_reduced("granite-moe-1b-a400m"),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    model = transformer.init_params(4, cfg, device="cpu")
    x = _t(np.random.default_rng(21).standard_normal((2, 5, cfg.d_model)),
           torch.bfloat16)
    host = model.logits(x)
    card = model.to("cuda").logits(x.to("cuda"))
    assert card.dtype == torch.float32
    assert _rel(card.cpu(), host) <= BLOCK_RTOL
