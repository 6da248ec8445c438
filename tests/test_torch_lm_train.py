"""The port's LM training path against the reference's, on the CPU.

The reference's parameters (`init_params`, reduced float32 configs) are
carried into the port through `models.convert`, the batches are drawn from
a seeded numpy generator, and both packages compute in float32.  Bounds:

* `loss_fn` within 1e-5 relative of the reference's, for all ten
  architectures; every gradient within 1e-4 of its leaf's largest
  magnitude (2e-4 for mamba2 and recurrentgemma, the bound their scans
  have), mapped onto the port's names by `convert.named_arrays`;
* one `make_train_step` step from `convert.from_reference_state` (one
  architecture of each family): the loss within 1e-5 relative, the
  grad norm and lr within 1e-5 relative, m and v within 1e-4 of their
  leaf's largest magnitude (2e-4 for the scans), and the updated
  parameters within lr * 1e-3 absolute, compared only where the
  reference's gradient exceeds 1e-3 of its leaf's largest magnitude: on
  Adam's first step m_hat / sqrt(v_hat) is g / |g|, so a gradient at the
  level of the float noise (~1e-6 of the leaf's largest) turns into +-lr
  whose sign either side may take;
* three steps of internlm2, and a step with `microbatch=2`: each loss
  within 1e-5 relative;
* `cosine_lr` within 1e-6 of the reference's;
* the two-level remat (`n_layers=4, remat_group=2`) against no remat:
  the same loss, bitwise (the same forward runs), and gradients within
  1e-6 of their leaf's largest magnitude;
* the scans that write in place when serving (the SSD, the RG-LRU) give
  bitwise the same outputs under `no_grad` as with a graph recorded.

The reference is imported inside the tests that use it, so the `cuda`
test (a card step against the host step) runs where JAX is not.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.launch.serve import generate
from repro_torch.models import convert, get_model, mamba2, rglru
from repro_torch.models.common import lm_loss_chunked, softmax_xent
from repro_torch.train import AdamWConfig, init_state, make_train_step
from repro_torch.train.optimizer import cosine_lr

torch.set_num_threads(1)

ARCHS = ["internvl2-1b", "gemma-7b", "internlm2-1.8b", "llama3-8b",
         "qwen2-7b", "llama4-scout-17b-a16e", "granite-moe-1b-a400m",
         "mamba2-130m", "recurrentgemma-9b", "seamless-m4t-large-v2"]
ONE_PER_FAMILY = ["internlm2-1.8b", "granite-moe-1b-a400m", "mamba2-130m",
                  "recurrentgemma-9b", "seamless-m4t-large-v2"]
LOSS_RTOL = 1e-5
GRAD_TOL = {"mamba2-130m": 2e-4, "recurrentgemma-9b": 2e-4}
GRAD_TOL_DEFAULT = 1e-4
REMAT_GRAD_TOL = 1e-6
UPDATE_GRAD_FLOOR = 1e-3
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _grad_tol(arch):
    return GRAD_TOL.get(arch, GRAD_TOL_DEFAULT)


def _ref_cfg(cfg):
    from repro.models import config as RC
    d = dataclasses.asdict(cfg)
    for key, cls in (("moe", RC.MoEConfig), ("ssm", RC.SSMConfig),
                     ("recurrent", RC.RecurrentConfig)):
        if d[key] is not None:
            d[key] = cls(**d[key])
    return RC.ArchConfig(**d)


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if cfg.family == "encdec":
        out["src_embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    elif cfg.frontend != "none":
        out["prefix_embeds"] = rng.standard_normal(
            (B, cfg.frontend_positions, cfg.d_model)).astype(np.float32)
    return out


def _leaf_err(ours, ref):
    ours = ours.detach().double().numpy() if isinstance(ours, torch.Tensor) \
        else np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30)


def _grads(model, cfg, batch):
    loss = get_model(cfg).loss_fn(model, batch, cfg)
    named = list(model.named_parameters())
    gs = torch.autograd.grad(loss, [p for _, p in named])
    return loss.detach(), {n: g for (n, _), g in zip(named, gs)}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    import jax
    import jax.numpy as jnp
    from repro.models import get_model as ref_get_model
    cfg = get_reduced(arch)
    rcfg = _ref_cfg(cfg)
    params = _np(ref_get_model(rcfg).init_params(jax.random.PRNGKey(1),
                                                 rcfg))
    batch = _batch(cfg)
    rl, rg = jax.value_and_grad(ref_get_model(rcfg).loss_fn)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, batch),
        cfg=rcfg)
    model = convert.from_reference_params(cfg, params, device="cpu")
    model.requires_grad_(True)
    loss, grads = _grads(model, cfg, batch)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(rl)) <= LOSS_RTOL * abs(float(rl))
    ref = convert.named_arrays(cfg, _np(rg))
    assert set(ref) == set(grads)
    for name, g in grads.items():
        assert _leaf_err(g, ref[name]) <= _grad_tol(arch), name


def _ref_train(rcfg, params_seed=1):
    import jax
    from repro.train import AdamWConfig as RefAdamW
    from repro.train import init_state as ref_init_state
    return ref_init_state(jax.random.PRNGKey(params_seed), rcfg), \
        RefAdamW(**OPT)


@pytest.mark.parametrize("arch", ONE_PER_FAMILY)
def test_one_train_step_matches_reference(arch):
    import functools
    import jax
    import jax.numpy as jnp
    from repro.models import get_model as ref_get_model
    from repro.train import make_train_step as ref_make_train_step
    cfg = get_reduced(arch)
    rcfg = _ref_cfg(cfg)
    rstate, ropt = _ref_train(rcfg)
    state = convert.from_reference_state(cfg, _np(rstate), device="cpu")
    batch = _batch(cfg, seed=3)
    # the reference's gradients at the starting point, for the mask
    rg = jax.grad(functools.partial(ref_get_model(rcfg).loss_fn, cfg=rcfg))(
        rstate["params"], jax.tree.map(jnp.asarray, batch))
    rg = convert.named_arrays(cfg, _np(rg))
    rnew, rmet = jax.jit(ref_make_train_step(rcfg, ropt))(
        rstate, jax.tree.map(jnp.asarray, batch))
    state, met = make_train_step(cfg, AdamWConfig(**OPT))(state, batch)
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(met[key]) - float(rmet[key])) \
            <= LOSS_RTOL * abs(float(rmet[key])), key
    assert int(state["opt"]["step"]) == int(rnew["opt"]["step"]) == 1
    tol = _grad_tol(arch)
    for which in ("m", "v"):
        ref = convert.named_arrays(cfg, _np(rnew["opt"][which]))
        for name, t in state["opt"][which].items():
            assert t.dtype == torch.float32
            assert _leaf_err(t, ref[name]) <= tol, (which, name)
    lr = float(rmet["lr"])
    ref_p = convert.named_arrays(cfg, _np(rnew["params"]))
    for name, p in state["params"].named_parameters():
        g = np.abs(rg[name])
        sure = g > UPDATE_GRAD_FLOOR * g.max()
        diff = np.abs(p.detach().numpy() - ref_p[name])
        assert diff[sure].max(initial=0.0) <= lr * 1e-3, name


def test_three_steps_and_a_microbatched_step_match_reference():
    import jax
    import jax.numpy as jnp
    from repro.train import make_train_step as ref_make_train_step
    cfg = get_reduced("internlm2-1.8b")
    rcfg = _ref_cfg(cfg)
    rstate, ropt = _ref_train(rcfg)
    state = convert.from_reference_state(cfg, _np(rstate), device="cpu")
    rstep = jax.jit(ref_make_train_step(rcfg, ropt))
    step = make_train_step(cfg, AdamWConfig(**OPT))
    for i in range(3):
        batch = _batch(cfg, B=4, seed=10 + i)
        rstate, rmet = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        state, met = step(state, batch)
        assert abs(float(met["loss"]) - float(rmet["loss"])) \
            <= LOSS_RTOL * abs(float(rmet["loss"])), i
    # microbatch=2 from the same state on both sides
    state = convert.from_reference_state(cfg, _np(rstate), device="cpu")
    batch = _batch(cfg, B=4, seed=20)
    rstate, rmet = jax.jit(ref_make_train_step(rcfg, ropt, microbatch=2))(
        rstate, jax.tree.map(jnp.asarray, batch))
    state, met = make_train_step(cfg, AdamWConfig(**OPT), microbatch=2)(
        state, batch)
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(met[key]) - float(rmet[key])) \
            <= LOSS_RTOL * abs(float(rmet[key])), key
    ref_m = convert.named_arrays(cfg, _np(rstate["opt"]["m"]))
    for name, t in state["opt"]["m"].items():
        assert _leaf_err(t, ref_m[name]) <= GRAD_TOL_DEFAULT, name


def test_cosine_lr_matches_reference():
    import jax.numpy as jnp
    from repro.train import AdamWConfig as RefAdamW
    from repro.train.optimizer import cosine_lr as ref_cosine_lr
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_ratio=0.1), OPT):
        for s in (0, 5, 10, 55, 100):
            ours = float(cosine_lr(AdamWConfig(**kw), s))
            ref = float(ref_cosine_lr(RefAdamW(**kw), jnp.int32(s)))
            assert abs(ours - ref) <= 1e-6 * max(1.0, abs(ref)), (kw, s)


@pytest.mark.parametrize("tied", [False, True])
def test_chunked_loss_is_the_full_softmax_xent(tied):
    """S = 37 in chunks of 16: two whole chunks and a padded one."""
    rng = np.random.default_rng(5)
    B, S, d, V = 2, 37, 8, 24
    x = torch.as_tensor(rng.standard_normal((B, S, d)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((V, d) if tied else (d, V)),
                        dtype=torch.float32)
    labels = torch.as_tensor(rng.integers(0, V, (B, S)))
    mask = torch.as_tensor(rng.random((B, S)) > 0.3, dtype=torch.float32)
    logits = x @ (w.t() if tied else w)
    for m in (mask, None):
        want = softmax_xent(logits, labels, m)
        got = lm_loss_chunked(x, w, labels, m, tied=tied, chunk=16)
        assert abs(float(got) - float(want)) <= 1e-6 * float(want)


def test_softmax_xent_matches_reference():
    import jax.numpy as jnp
    from repro.models.common import softmax_xent as ref_xent
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5))
    mask = (rng.random((3, 5)) > 0.4).astype(np.float32)
    for m in (mask, None):
        ours = softmax_xent(torch.as_tensor(logits), torch.as_tensor(labels),
                            None if m is None else torch.as_tensor(m))
        ref = ref_xent(jnp.asarray(logits), jnp.asarray(labels),
                       None if m is None else jnp.asarray(m))
        assert abs(float(ours) - float(ref)) <= 1e-6 * float(ref)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-130m",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_two_level_remat_equals_no_remat(arch, monkeypatch):
    """n_layers=4, remat_group=2: the reduced configs' 2 or 3 layers fall
    back to groups of one, so only this reaches the two-level path (for
    recurrentgemma one pattern group of 3 and a tail layer)."""
    cfg = dataclasses.replace(get_reduced(arch), n_layers=4, remat_group=2,
                              remat=True)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, n_layers_decoder=4)
    model = init_state(7, cfg, device="cpu")["params"]
    batch = _batch(cfg, seed=8)
    import repro_torch.models.common as common
    calls = []
    real = common.checkpoint

    def counting(fn, *a, **kw):
        calls.append(fn)
        return real(fn, *a, **kw)
    monkeypatch.setattr(common, "checkpoint", counting)
    on, g_on = _grads(model, cfg, batch)
    monkeypatch.undo()
    # two levels: a group's checkpoint and its layers' inside it
    assert any(getattr(f, "__name__", "") == "group_fn" for f in calls)
    off, g_off = _grads(model, dataclasses.replace(cfg, remat=False), batch)
    assert torch.equal(on, off)
    for name in g_on:
        assert _leaf_err(g_on[name], g_off[name].numpy()) <= REMAT_GRAD_TOL, \
            name


def test_remat_groups_follow_the_reference_rule():
    from repro_torch.models.common import remat_groups
    assert remat_groups(24, 4) == [list(range(i, i + 4))
                                   for i in range(0, 24, 4)]
    assert remat_groups(2, 4) == [[0], [1]]
    assert remat_groups(3, 0) == [[0], [1], [2]]


def test_ssd_scan_is_unchanged_with_a_graph_recorded():
    rng = np.random.default_rng(40)
    B, S, H, P, N = 2, 45, 3, 4, 8
    args = [torch.as_tensor(a, dtype=torch.float32) for a in (
        rng.standard_normal((B, S, H, P)), rng.uniform(0.05, 0.5, (B, S, H)),
        -rng.uniform(0.5, 1.5, (H,)), rng.standard_normal((B, S, N)),
        rng.standard_normal((B, S, N)))]
    with torch.no_grad():
        y0, h0 = mamba2._ssd_chunked(*args, chunk=16)
    rec = [a.clone().requires_grad_(True) for a in args]
    y1, h1 = mamba2._ssd_chunked(*rec, chunk=16)
    assert y1.requires_grad and torch.equal(y0, y1.detach())
    assert torch.equal(h0, h1.detach())
    (y1.sum() + h1.sum()).backward()
    assert all(torch.isfinite(a.grad).all() for a in rec)


def test_rglru_scan_is_unchanged_with_a_graph_recorded():
    """S = 300: two chunks of the recurrence (256 and a short 44)."""
    cfg = get_reduced("recurrentgemma-9b")
    layer = rglru.RecLayer(cfg, device=torch.device("cpu"),
                           dtype=torch.float32,
                           generator=torch.Generator().manual_seed(2))
    xb = torch.as_tensor(np.random.default_rng(41).standard_normal(
        (2, 300, cfg.recurrent.lru_width)) * 0.3, dtype=torch.float32)
    with torch.no_grad():
        y0, h0 = layer.rglru(xb)
    layer.requires_grad_(True)
    y1, h1 = layer.rglru(xb.clone().requires_grad_(True))
    assert y1.requires_grad
    assert torch.equal(y0, y1.detach()) and torch.equal(h0, h1.detach())
    a = torch.rand(2, 9, 5) + 0.1
    b = torch.randn(2, 9, 5)
    want = rglru._linear_scan(a.clone(), b.clone())
    got = rglru._linear_scan(a.clone().requires_grad_(True),
                             b.clone().requires_grad_(True))
    assert torch.equal(want, got.detach())


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-130m",
                                  "recurrentgemma-9b"])
def test_serving_records_no_graph(arch):
    """A model from `init_params` is frozen: `forward` outside `no_grad`
    and `generate` record no graph."""
    cfg = get_reduced(arch)
    M = get_model(cfg)
    model = M.init_params(4, cfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 7)))
    logits, aux = M.forward(model, tokens, cfg)
    assert not logits.requires_grad and logits.grad_fn is None
    out = generate(cfg, model, tokens, 3, 12)
    assert out.shape == (2, 3) and not out.requires_grad


def test_init_state_trains_the_model_it_draws():
    cfg = get_reduced("internlm2-1.8b")
    state = init_state(3, cfg, device="cpu")
    model = state["params"]
    assert all(p.requires_grad for p in model.parameters())
    names = [n for n, _ in model.named_parameters()]
    assert list(state["opt"]["m"]) == names == list(state["opt"]["v"])
    assert all(t.dtype == torch.float32 and not t.any()
               for t in state["opt"]["m"].values())
    assert state["opt"]["step"].dtype == torch.int32


def test_init_state_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(0, get_reduced("internlm2-1.8b"))


@pytest.mark.cuda
def test_cuda_train_step_matches_the_host_step():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import copy
    cfg = get_reduced("internlm2-1.8b")
    host = init_state(5, cfg, device="cpu")
    card = {"params": copy.deepcopy(host["params"]).cuda(),
            "opt": {k: ({n: t.cuda() for n, t in v.items()}
                        if isinstance(v, dict) else v.cuda())
                    for k, v in host["opt"].items()}}
    batch = _batch(cfg, B=4, S=64, seed=11)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card, mc = make_train_step(cfg, AdamWConfig(**OPT))(card, batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    host, mh = make_train_step(cfg, AdamWConfig(**OPT))(host, batch)
    for key in ("loss", "grad_norm", "lr"):
        assert abs(float(mc[key]) - float(mh[key])) \
            <= 1e-4 * abs(float(mh[key])), key
    for (n, p), (_, q) in zip(card["params"].named_parameters(),
                              host["params"].named_parameters()):
        assert _leaf_err(p.cpu(), q.detach().numpy()) <= 1e-4, n


@pytest.mark.cuda
def test_cuda_bf16_float32_product_has_the_16_bit_gradient():
    """On the card a bf16 product with a float32 output (the loss's
    logits) backpropagates as a bf16 product does: its gradients within
    bf16 rounding (2**-7 relative) of the float32 product's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models.common import float32_product
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(3, 40, 64, device="cuda", generator=g).bfloat16()
    w = torch.randn(96, 64, device="cuda", generator=g).bfloat16()
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = float32_product(x, w)
    assert y.dtype == torch.float32
    y.square().sum().backward()
    xr = x.detach().float().requires_grad_(True)
    wr = w.detach().float().requires_grad_(True)
    (xr @ wr.t()).square().sum().backward()
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    for got, want in ((x.grad, xr.grad), (w.grad, wr.grad)):
        assert _leaf_err(got.float().cpu(), want.cpu().numpy()) <= 2 ** -7
