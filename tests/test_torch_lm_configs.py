"""The port's LM configs and input specs against the reference's, on the
CPU.

* every architecture's full and reduced config equals the reference's
  field for field (`dataclasses.asdict`), and so do `CLI_IDS`,
  `all_arch_ids`, `params_count`, `active_params_count` and
  `padded_vocab`;
* `input_specs` for all 40 (arch x shape) cells: the same kinds, keys,
  shapes and dtypes as the reference's `ShapeDtypeStruct`s, every port
  spec a tensor on the meta device, and the same 8 skips;
* all ten architectures at full size on the meta device: every
  parameter's shape and dtype equal `jax.eval_shape` of the reference's
  `init_params` (its stacked blocks, groups and tail unstacked into
  layers), and nothing is allocated.

Exact equality throughout (no tolerance: these are integers and shapes).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as P
from repro_torch.launch import specs as S
from repro_torch.models import convert, get_model

torch.set_num_threads(1)

ARCHS = sorted(P.CLI_IDS)


def test_registry_matches_reference():
    from repro import configs as R
    assert P.ARCHS == R.ARCHS
    assert P.CLI_IDS == R.CLI_IDS
    assert P.all_arch_ids() == R.all_arch_ids()


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    from repro import configs as R
    for ours, theirs in ((P.get_config(arch), R.get_config(arch)),
                         (P.get_reduced(arch), R.get_reduced(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.params_count() == theirs.params_count()
        assert ours.active_params_count() == theirs.active_params_count()
        assert ours.padded_vocab == theirs.padded_vocab
        assert ours.resolved_head_dim == theirs.resolved_head_dim
        assert ours.sub_quadratic == theirs.sub_quadratic
    # the module spellings resolve too (gemma_7b, internlm2_1_8b, ...)
    assert P.get_config(P.CLI_IDS[arch]) == P.get_config(arch)


def _flat(spec, prefix=""):
    if isinstance(spec, dict):
        for k, v in spec.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(spec, list):
        for i, v in enumerate(spec):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], spec


@pytest.mark.parametrize("shape", sorted(S.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    from repro import configs as R
    from repro.launch import specs as RS
    cfg, rcfg = P.get_config(arch), R.get_config(arch)
    assert dataclasses.asdict(S.SHAPES[shape]) == \
        dataclasses.asdict(RS.SHAPES[shape])
    assert S.cell_is_applicable(cfg, shape) == \
        RS.cell_is_applicable(rcfg, shape)
    assert S.skip_reason(cfg, shape) == RS.skip_reason(rcfg, shape)
    if not S.cell_is_applicable(cfg, shape):
        return
    ours = dict(_flat(S.input_specs(cfg, shape)))
    theirs = dict(_flat(RS.input_specs(rcfg, shape)))
    assert sorted(ours) == sorted(theirs)
    for k, v in ours.items():
        t = theirs[k]
        if isinstance(v, torch.Tensor):
            assert v.is_meta, k
            assert tuple(v.shape) == tuple(t.shape), k
            assert str(v.dtype).removeprefix("torch.") == \
                np.dtype(t.dtype).name, k
        else:
            assert v == t, k


def test_input_specs_cover_the_40_cells():
    cells = [(a, s) for a in ARCHS for s in S.SHAPES]
    skips = [c for c in cells if not S.cell_is_applicable(
        P.get_config(c[0]), c[1])]
    assert len(cells) == 40
    assert len(skips) == 8 and {s for _, s in skips} == {"long_500k"}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_shapes_on_meta_match_reference(arch):
    import jax
    from repro import configs as R
    from repro.models import get_model as ref_get_model
    cfg, rcfg = P.get_config(arch), R.get_config(arch)
    model = get_model(cfg).init_params(0, cfg, device="meta")
    assert all(p.is_meta for p in model.parameters())
    ref = jax.eval_shape(lambda k: ref_get_model(rcfg).init_params(k, rcfg),
                         jax.random.PRNGKey(0))
    theirs = convert.reference_shapes(cfg, ref)
    ours = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert ours == theirs
    dtypes = {k: np.dtype(leaf.dtype).name
              for k, leaf, _ in convert._leaves(cfg, ref)}
    assert {k: str(p.dtype).removeprefix("torch.")
            for k, p in model.named_parameters()} == dtypes
    assert "bfloat16" in dtypes.values()
