"""The port's ssm, hybrid and encdec LM families against the reference's,
on the CPU.

The same parameters (the reference's `init_*` draws, carried into the
port's modules through numpy: `models.convert.from_reference_params` for
whole models) and the same inputs (a seeded numpy generator) go through
both packages, in float32 (the reduced configs).  Tolerances, relative to
the reference output's scale (max |ref|, at least 1):

* the scans: `mamba2._ssd_chunked` (S = 48 with chunk 16, a padded
  S = 45, a carried-in state) and the RG-LRU recurrence (S = 20, and
  S = 300 with chunk 256: the chunk boundary and a short last chunk)
  within 1e-4 of the reference's, and within 2e-4 (absolute and
  relative, as `tests/test_models.py` holds the reference) of the naive
  recurrence and of the port's own step-by-step decode path;
* whole models (`forward`, `prefill` logits and the whole cache or state,
  two decode steps with the cache after each): 1e-4, for mamba2,
  recurrentgemma at its reduced 3 layers, at 5 layers (a tail of 2
  unstacked recurrent layers), past its window (prompt 24 > window 16,
  as `test_local_attention_window_ring`), and seamless with
  `scan_layers` True and False;
* prefill plus one decode step against `forward` on the prompt plus that
  token, the port's own parameters: 1e-4.

Shapes are compared exactly: the caches against `launch.specs`, the
converter's refusals.  The reference is imported inside the tests and
helpers that use it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import specs as S
from repro_torch.models import convert, encdec, get_model, mamba2, rglru

torch.set_num_threads(1)

MODEL_RTOL = 1e-4
SCAN_RTOL = 1e-4
NAIVE_TOL = 2e-4
CPU = torch.device("cpu")
FAMILY_ARCHS = ["mamba2-130m", "recurrentgemma-9b", "seamless-m4t-large-v2"]


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    assert x.shape == ref.shape, (x.shape, ref.shape)
    return np.abs(x - ref).max() / max(1.0, np.abs(ref).max())


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _ref_cfg(cfg):
    from repro.models import config as RC
    d = dataclasses.asdict(cfg)
    for key, cls in (("moe", RC.MoEConfig), ("ssm", RC.SSMConfig),
                     ("recurrent", RC.RecurrentConfig)):
        if d[key] is not None:
            d[key] = cls(**d[key])
    return RC.ArchConfig(**d)


def _ref_params(cfg, seed=1):
    import jax
    from repro.models import get_model as ref_get_model
    rcfg = _ref_cfg(cfg)
    return _np(ref_get_model(rcfg).init_params(jax.random.PRNGKey(seed),
                                               rcfg))


def _leaves(cache):
    """The cache's arrays in a fixed order (dicts by sorted key, lists in
    order), numpy."""
    if isinstance(cache, dict):
        return [a for k in sorted(cache) for a in _leaves(cache[k])]
    if isinstance(cache, (list, tuple)):
        return [a for c in cache for a in _leaves(c)]
    return [np.asarray(cache.numpy() if isinstance(cache, torch.Tensor)
                       else cache)]


def _assert_caches_match(ours, theirs, where):
    a, b = _leaves(ours), _leaves(theirs)
    assert len(a) == len(b), where
    for x, y in zip(a, b):
        assert _rel(x, y) <= MODEL_RTOL, where


# -- the scans ----------------------------------------------------------------


def _naive_ssd(xh, dt, A, Bm, Cm, h0):
    h = np.array(h0, np.float64)
    ys = []
    for t in range(xh.shape[1]):
        a = np.exp(dt[:, t] * A[None])                          # (B,H)
        xdt = xh[:, t] * dt[:, t][..., None]
        h = h * a[..., None, None] + np.einsum("bn,bhp->bhpn", Bm[:, t], xdt)
        ys.append(np.einsum("bn,bhpn->bhp", Cm[:, t], h))
    return np.stack(ys, axis=1), h


@pytest.mark.parametrize("S,carried", [(48, False), (45, False), (45, True)])
def test_ssd_chunked_matches_reference_and_naive(S, carried):
    """Chunk 16: three whole chunks (48), a padded last chunk (45), and a
    state carried in (the reference's h0)."""
    import jax.numpy as jnp
    from repro.models.mamba2 import _ssd_chunked as ref_ssd
    rng = np.random.default_rng(30)
    B, H, P, N = 2, 3, 4, 8
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.05, 0.5, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 1.5, (H,)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32) if carried \
        else np.zeros((B, H, P, N), np.float32)
    y, hT = mamba2._ssd_chunked(_t(xh), _t(dt), _t(A), _t(Bm), _t(Cm),
                                chunk=16, h0=_t(h0) if carried else None)
    ry, rhT = ref_ssd(*(jnp.asarray(a) for a in (xh, dt, A, Bm, Cm)),
                      chunk=16, h0=jnp.asarray(h0) if carried else None)
    assert y.dtype == torch.float32 and hT.dtype == torch.float32
    assert np.isfinite(y.numpy()).all()
    assert _rel(y, ry) <= SCAN_RTOL and _rel(hT, rhT) <= SCAN_RTOL
    ny, nh = _naive_ssd(xh, dt, A, Bm, Cm, h0)
    np.testing.assert_allclose(y.numpy(), ny, rtol=NAIVE_TOL, atol=NAIVE_TOL)
    np.testing.assert_allclose(hT.numpy(), nh, rtol=NAIVE_TOL,
                               atol=NAIVE_TOL)


def _rec_layer_pair(cfg, seed=3):
    import jax
    import jax.numpy as jnp
    from repro.models.rglru import _init_layer
    p = _np(_init_layer(jax.random.PRNGKey(seed), "rec", _ref_cfg(cfg),
                        jnp.float32))
    layer = rglru.RecLayer(cfg, device=CPU, dtype=torch.float32)
    ours = dict(layer.named_parameters())
    theirs = dict(convert._flatten(p))
    assert set(ours) == set(theirs)
    with torch.no_grad():
        for k, v in ours.items():
            v.copy_(torch.as_tensor(np.array(theirs[k])))
    return layer, p


def test_linear_scan_is_the_recurrence():
    """The doubling scan against the loop h_t = a_t h_{t-1} + b_t, for
    lengths around powers of two."""
    rng = np.random.default_rng(31)
    for T in (1, 2, 5, 8, 33, 256):
        a = rng.uniform(0.0, 1.0, (2, T, 3))
        b = rng.standard_normal((2, T, 3))
        h, want = np.zeros((2, 3)), []
        for t in range(T):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        got = rglru._linear_scan(torch.as_tensor(a), torch.as_tensor(b))
        np.testing.assert_allclose(got.numpy(), np.stack(want, 1),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("S", [20, 300])
def test_rglru_scan_matches_reference_and_stepwise(S):
    """y against the reference's `_rglru`, and y and the carried state
    against the port's own step-by-step decode path.  At S = 300 (chunk
    256, a short last chunk) the reference's carried state has also run
    through its 212 padded steps (ROADMAP R8): the port's is the state at
    the last real step, which the reference's y[:, -1] holds."""
    import jax.numpy as jnp
    from repro.models.rglru import _rglru as ref_rglru
    cfg = get_reduced("recurrentgemma-9b")
    layer, p = _rec_layer_pair(cfg)
    w = cfg.recurrent.lru_width
    xb = (np.random.default_rng(32).standard_normal((2, S, w)) * 0.3
          ).astype(np.float32)
    y, h_last = layer.rglru(_t(xb))
    ry, rh = ref_rglru(p, jnp.asarray(xb))
    assert _rel(y, ry) <= SCAN_RTOL
    assert _rel(h_last, np.asarray(ry)[:, -1]) <= SCAN_RTOL
    if S <= 256:
        assert _rel(h_last, rh) <= SCAN_RTOL
    else:
        assert _rel(rh, np.asarray(ry)[:, -1]) > 1e-2    # R8
    h = torch.zeros((2, w))
    for t in range(S):
        yt, h = layer.rglru(_t(xb[:, t:t + 1]), h0=h)
        np.testing.assert_allclose(yt[:, 0].numpy(), y[:, t].numpy(),
                                   rtol=NAIVE_TOL, atol=NAIVE_TOL)
    np.testing.assert_allclose(h.numpy(), h_last.numpy(), rtol=NAIVE_TOL,
                               atol=NAIVE_TOL)


# -- whole models -------------------------------------------------------------

MODEL_CASES = {
    # name: (arch, replace, prompt, cache_len or None for prompt + 1)
    "mamba2": ("mamba2-130m", {}, 11, None),
    "rgemma": ("recurrentgemma-9b", {}, 11, None),
    "rgemma_tail": ("recurrentgemma-9b", {"n_layers": 5}, 11, None),
    "rgemma_past_window": ("recurrentgemma-9b", {}, 24, 16),
    "seamless_scan": ("seamless-m4t-large-v2", {"scan_layers": True}, 11,
                      None),
    "seamless_list": ("seamless-m4t-large-v2", {"scan_layers": False}, 11,
                      None),
}


def _family_inputs(cfg, B, S, rng):
    """(tokens, port kwargs, reference kwargs): encdec's source frames
    (7 of them, fewer than the prompt's tokens) come after the tokens."""
    import jax.numpy as jnp
    tokens = rng.integers(0, cfg.vocab, (B, S))
    if cfg.family != "encdec":
        return tokens, {}, {}
    src = rng.standard_normal((B, 7, cfg.d_model)).astype(np.float32)
    return tokens, {"src_embeds": _t(src)}, {"src_embeds": jnp.asarray(src)}


def _forward(M, model, cfg, tokens, kw):
    if cfg.family == "encdec":
        return M.forward(model, kw["src_embeds"], tokens, cfg)
    return M.forward(model, tokens, cfg)


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_family_model_matches_reference(case):
    """forward, prefill (last logits and the whole cache or state) and two
    decode steps (logits and the whole cache after each); the second
    wraps a ring of prompt + 1 slots, or both run past recurrentgemma's
    window."""
    import jax.numpy as jnp
    from repro.models import get_model as ref_get_model
    arch, repl, S, cache_len = MODEL_CASES[case]
    cfg = dataclasses.replace(get_reduced(arch), **repl)
    rcfg = _ref_cfg(cfg)
    ref, M = ref_get_model(rcfg), get_model(cfg)
    p = _ref_params(cfg)
    model = convert.from_reference_params(cfg, p, device="cpu")
    B = 2
    rng = np.random.default_rng(33)
    tokens, kw, rkw = _family_inputs(cfg, B, S, rng)
    rtok = jnp.asarray(tokens, jnp.int32)
    logits, _ = _forward(M, model, cfg, tokens, kw)
    if cfg.family == "encdec":
        rlogits, _ = ref.forward(p, rkw["src_embeds"], rtok, rcfg)
    else:
        rlogits, _ = ref.forward(p, rtok, rcfg)
    assert logits.shape == (B, S, cfg.padded_vocab)
    assert _rel(logits.detach(), rlogits) <= MODEL_RTOL
    cache_len = cache_len or S + 1
    lp, cache = M.prefill(model, tokens, cfg, cache_len, **kw)
    rlp, rcache = ref.prefill(p, rtok, rcfg, cache_len=cache_len, **rkw)
    assert _rel(lp, rlp) <= MODEL_RTOL
    _assert_caches_match(cache, _np(rcache), "prefill")
    nxt = rng.integers(0, cfg.vocab, (B, 2))
    for i in range(2):
        ld, cache = M.decode_step(model, nxt[:, i:i + 1], cache, S + i, cfg)
        rld, rcache = ref.decode_step(
            p, jnp.asarray(nxt[:, i:i + 1], jnp.int32), rcache,
            jnp.int32(S + i), rcfg)
        assert np.isfinite(ld.numpy()).all()
        assert _rel(ld, rld) <= MODEL_RTOL, i
        _assert_caches_match(cache, _np(rcache), f"decode {i}")


def test_rgemma_tail_layers_convert_in_layer_order():
    """5 layers under (rec, rec, attn): one group and a tail of two
    recurrent layers; group p's slice 0 is layer p, tail i is layer 3 + i."""
    cfg = dataclasses.replace(get_reduced("recurrentgemma-9b"), n_layers=5)
    p = _ref_params(cfg)
    assert len(p["tail"]) == 2 and len(p["groups"]) == 3
    model = convert.from_reference_params(cfg, p, device="cpu")
    kinds = [type(layer).__name__ for layer in model.layers]
    assert kinds == ["RecLayer", "RecLayer", "AttnLayer", "RecLayer",
                     "RecLayer"]
    for i in range(3):
        w = p["groups"][i]["mlp"]["up"]["w"][0]
        assert np.array_equal(model.layers[i].mlp.up.w.numpy(), w)
    for i in range(2):
        assert np.array_equal(model.layers[3 + i].gate_a.w.numpy(),
                              p["tail"][i]["gate_a"]["w"])
    assert rglru.layer_params(model, cfg, 4) is model.layers[4]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_prefill_decode_matches_forward(arch):
    """prefill(prompt) + decode_step == forward(prompt + token), the
    port's own parameters; a prompt of 40 crosses mamba2's chunk of 32
    (padded) and recurrentgemma's window of 16."""
    cfg = get_reduced(arch)
    M = get_model(cfg)
    model = M.init_params(1, cfg, device="cpu")
    B, S = 2, 40
    rng = np.random.default_rng(34)
    toks, kw, _ = _family_inputs(cfg, B, S + 1, rng)
    prompt, nxt = toks[:, :S], toks[:, S:]
    lp, cache = M.prefill(model, prompt, cfg, cache_len=S + 4, **kw)
    ld, _ = M.decode_step(model, nxt, cache, S, cfg)
    full, _ = _forward(M, model, cfg, toks, kw)
    assert _rel(ld[:, 0], full[:, -1].detach()) <= MODEL_RTOL
    assert _rel(lp[:, -1], full[:, S - 1].detach()) <= MODEL_RTOL


# -- shapes, dispatch, conversion ----------------------------------------------


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cache_shapes_match_specs(arch):
    """init_state / init_cache at decode_32k on the meta device: the
    shapes and dtypes of `launch.specs.input_specs`' cache."""
    cfg = get_config(arch)
    spec = S.input_specs(cfg, "decode_32k")
    B, L = spec["token"].shape[0], spec["cache_len"]
    M = get_model(cfg)
    if cfg.family == "ssm":
        cache = M.init_state(cfg, B, torch.bfloat16, device="meta")
    else:
        cache = M.init_cache(cfg, B, L, torch.bfloat16, device="meta")
    ours, theirs = _leaves_meta(cache), _leaves_meta(spec["cache"])
    assert [(tuple(a.shape), a.dtype) for a in ours] == \
        [(tuple(b.shape), b.dtype) for b in theirs]
    assert all(a.is_meta for a in ours)


def _leaves_meta(cache):
    if isinstance(cache, dict):
        return [a for k in sorted(cache) for a in _leaves_meta(cache[k])]
    if isinstance(cache, list):
        return [a for c in cache for a in _leaves_meta(c)]
    return [cache]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_convert_raises_on_a_mismatched_tree_of_each_family(arch):
    """A missing key, an unexpected key, a shape that differs, and a
    stacked leaf whose leading axis is not the layer count."""
    cfg = get_reduced(arch)
    p = _ref_params(cfg)
    with pytest.raises(ValueError, match="missing"):
        convert.from_reference_params(cfg, {k: v for k, v in p.items()
                                            if k != "ln_f"}, device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        convert.from_reference_params(
            cfg, dict(p, extra={"w": p["ln_f"]["scale"]}), device="cpu")
    wide = dict(p, ln_f={"scale": np.ones(cfg.d_model + 1, np.float32)})
    with pytest.raises(ValueError, match="shapes"):
        convert.from_reference_params(cfg, wide, device="cpu")
    if cfg.family == "ssm":
        bad = dict(p, blocks={**p["blocks"], "D": p["blocks"]["D"][:1]})
        match = "stacked"
    elif cfg.family == "hybrid":
        bad = dict(p, groups=p["groups"][:2])        # one position short
        match = "missing"
    else:
        bad = dict(p, dec={**p["dec"], "ln1": {
            "scale": p["dec"]["ln1"]["scale"][:1]}})
        match = "stacked"
    with pytest.raises(ValueError, match=match):
        convert.from_reference_params(cfg, bad, device="cpu")


def test_seamless_without_stacked_layers_converts_its_lists():
    cfg = dataclasses.replace(get_reduced("seamless-m4t-large-v2"),
                              scan_layers=False)
    p = _ref_params(cfg)
    assert isinstance(p["enc"], list) and isinstance(p["dec"], list)
    model = convert.from_reference_params(cfg, p, device="cpu")
    assert np.array_equal(model.dec[1].cross.k.w.numpy(),
                          p["dec"][1]["cross"]["k"]["w"])
    assert np.array_equal(model.enc[0].mlp.down.w.numpy(),
                          p["enc"][0]["mlp"]["down"]["w"])


def test_encdec_prefill_needs_the_source():
    cfg = get_reduced("seamless-m4t-large-v2")
    model = encdec.init_params(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="src_embeds"):
        encdec.prefill(model, np.zeros((1, 3), np.int64), cfg, 8)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_entry_points_need_a_card_unless_asked_for_the_cpu(
        arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced(arch)
    M = get_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if cfg.family == "ssm":
            M.init_state(cfg, 1, torch.float32)
        else:
            M.init_cache(cfg, 1, 4, torch.float32)
    assert M.init_params(0, cfg, device="cpu").device == CPU


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cuda_family_model_matches_the_cpu_model(arch):
    """The same parameters on the card and on the host: prefill (logits
    and the whole cache or state) and two decode steps within 1e-4
    relative to scale (the card's float32 matmuls)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = get_reduced(arch)
    M = get_model(cfg)
    cpu = M.init_params(5, cfg, device="cpu")
    card = M.init_params(5, cfg, device="cpu").to("cuda")
    rng = np.random.default_rng(35)
    tokens = rng.integers(0, cfg.vocab, (2, 20))
    kw = {}
    if cfg.family == "encdec":
        kw = {"src_embeds": torch.as_tensor(
            rng.standard_normal((2, 9, cfg.d_model)), dtype=torch.float32)}
    lp, cache = M.prefill(cpu, tokens, cfg, 21, **kw)
    lpc, cachec = M.prefill(card, torch.as_tensor(tokens).cuda(), cfg, 21,
                            **{k: v.cuda() for k, v in kw.items()})
    assert _rel(lpc.cpu(), lp) <= MODEL_RTOL

    def leaves(c):
        return [a.cpu() for a in _leaves_meta(c)]
    for a, b in zip(leaves(cachec), leaves(cache)):
        assert _rel(a, b) <= MODEL_RTOL
    for i in range(2):
        tok = tokens[:, i:i + 1]
        ld, cache = M.decode_step(cpu, tok, cache, 20 + i, cfg)
        ldc, cachec = M.decode_step(card, torch.as_tensor(tok).cuda(),
                                    cachec, 20 + i, cfg)
        assert _rel(ldc.cpu(), ld) <= MODEL_RTOL, i
