"""The port's code-size metric and MatrixMarket io against the reference's.

`repro_torch.core.codegen` and `repro_torch.sparse.io` are numpy copies of
`repro.core.codegen` and `repro.sparse.io`.  The same seeds give:

* `generated_code_bytes`, `generate_c_source` and `transform(...).metrics.
  code_bytes_before/after` equal to the reference's, exactly (integers
  and strings, no tolerance), on `random_lower` and the reduced lung2 and
  torso2 analogues under three strategies;
* `read_matrix_market` CSR arrays equal to the reference's reading of the
  same file, exactly: general, symmetric, skew-symmetric, pattern, and
  gzip-compressed, all written into the test's `tmp_path`;
* a write/read round trip that gives back the same CSR, exactly
  (`%.17g` literals round-trip float64);
* `load_named` falling back to the analogues without REPRO_MATRIX_DIR, and
  reading the lower triangle of a local file with it, as the reference.
Nothing is downloaded.
"""
import gzip

import numpy as np
import pytest
import torch

from repro_torch.core import generate_c_source, generated_code_bytes
from repro_torch.core.portfolio import make_strategy
from repro_torch.core.transform import _strict_lower_csr, transform
from repro_torch.sparse import build_levels, generators
from repro_torch.sparse import io as sio
from repro_torch.sparse.csr import CSR

torch.set_num_threads(1)

MATRICES = {
    "random_lower(300)": lambda g: g.random_lower(300, avg_offdiag=3.0,
                                                  seed=5),
    "lung2_like(0.05)": lambda g: g.lung2_like(0.05),
    "torso2_like(0.04)": lambda g: g.torso2_like(0.04),
}
STRATEGIES = ("no_rewriting", "avgLevelCost", "manual_every_k")


def _csr_equal(a, b):
    assert a.shape == b.shape
    for name in ("indptr", "indices", "data"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_code_size_equals_the_reference(name, strategy):
    from repro.core import generate_c_source as ref_source
    from repro.core import generated_code_bytes as ref_bytes
    from repro.core.portfolio import make_strategy as ref_make_strategy
    from repro.core.transform import transform as ref_transform
    from repro.sparse import generators as ref_gen
    L, L_ref = MATRICES[name](generators), MATRICES[name](ref_gen)
    ts = transform(L, make_strategy(strategy), validate=False)
    ts_ref = ref_transform(L_ref, ref_make_strategy(strategy),
                           validate=False)
    m, m_ref = ts.metrics, ts_ref.metrics
    assert m.code_bytes_before == m_ref.code_bytes_before > 0
    assert m.code_bytes_after == m_ref.code_bytes_after > 0
    assert m.table1_row()["code_MB"] == m_ref.table1_row()["code_MB"]
    # the functions themselves, on the transformed system and on L
    lv = ts.level_of_assigned
    assert generated_code_bytes(ts.A, None, ts.diag, lv) == \
        ref_bytes(ts_ref.A, None, ts_ref.diag, ts_ref.level_of_assigned) \
        == m.code_bytes_after
    c = np.random.default_rng(0).standard_normal(L.n_rows)
    for consts in (None, c):
        src = generate_c_source(ts.A, consts, ts.diag, lv, max_rows=200)
        assert src == ref_source(ts_ref.A, consts, ts_ref.diag,
                                 ts_ref.level_of_assigned, max_rows=200)
    A0 = _strict_lower_csr(L)
    lv0 = build_levels(L).level_of
    assert generated_code_bytes(A0, None, L.diagonal_fast(), lv0) == \
        m.code_bytes_before


def test_generated_source_has_one_function_a_level_and_a_line_a_row():
    L = generators.random_lower(60, avg_offdiag=2.0, seed=1)
    ts = transform(L, make_strategy("avgLevelCost"), validate=False)
    src = generate_c_source(ts.A, None, ts.diag, ts.level_of_assigned)
    assert src.count("void calculate") == ts.metrics.num_levels_after
    assert src.count("  x[") == L.n_rows
    # the estimator counts the scaffold exactly and literals at 19 chars
    assert abs(len(src) - ts.metrics.code_bytes_after) < \
        0.5 * ts.metrics.code_bytes_after


def _mtx(path, header, size, entries, compress=False):
    text = f"%%MatrixMarket matrix coordinate {header}\n% a comment\n" \
           f"{size}\n" + "".join(f"{e}\n" for e in entries)
    if compress:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return path


FILES = {
    "general": ("real general", "3 3 4",
                ["1 1 2.5", "2 1 -1.25", "3 2 0.5", "3 3 4"], False),
    "symmetric": ("real symmetric", "3 3 5",
                  ["1 1 4", "2 1 -1", "2 2 4", "3 2 -1", "3 3 4"], False),
    "skew-symmetric": ("real skew-symmetric", "3 3 2",
                       ["2 1 1.5", "3 1 -2"], False),
    "pattern": ("pattern general", "3 4 3", ["1 1", "2 4", "3 2"], False),
    "gz": ("real symmetric", "4 4 6",
           ["1 1 2", "2 2 2", "3 3 2", "4 4 2", "3 1 0.25", "4 2 -0.5"],
           True),
}


@pytest.mark.parametrize("kind", sorted(FILES))
def test_read_matrix_market_equals_the_reference(kind, tmp_path):
    from repro.sparse import io as ref_io
    header, size, entries, gz = FILES[kind]
    path = _mtx(tmp_path / ("m.mtx.gz" if gz else "m.mtx"), header, size,
                entries, compress=gz)
    got, want = sio.read_matrix_market(path), ref_io.read_matrix_market(path)
    _csr_equal(got, want)
    dense = got.to_dense()
    if kind in ("symmetric", "gz"):
        np.testing.assert_array_equal(dense, dense.T)
    if kind == "skew-symmetric":
        np.testing.assert_array_equal(dense, -dense.T)
    if kind == "pattern":
        assert got.shape == (3, 4) and set(got.data) == {1.0}


@pytest.mark.parametrize("name", ["random_lower(300)", "lung2_like(0.05)"])
def test_matrix_market_round_trip(name, tmp_path):
    from repro.sparse import io as ref_io
    L = MATRICES[name](generators)
    path = tmp_path / "L.mtx"
    sio.write_matrix_market(L, path)
    back = sio.read_matrix_market(path)
    _csr_equal(back, L)
    ref_path = tmp_path / "L_ref.mtx"
    ref_io.write_matrix_market(L, ref_path)
    assert path.read_bytes() == ref_path.read_bytes()


def test_load_named_falls_back_to_the_analogues(monkeypatch):
    from repro.sparse import io as ref_io
    monkeypatch.delenv("REPRO_MATRIX_DIR", raising=False)
    for name in ("lung2", "torso2"):
        _csr_equal(sio.load_named(name), ref_io.load_named(name))
    _csr_equal(sio.load_named("lung2"), generators.lung2_like())
    with pytest.raises(KeyError):
        sio.load_named("no_such_matrix")


@pytest.mark.parametrize("gz", [False, True])
def test_load_named_reads_a_local_matrix_dir(gz, tmp_path, monkeypatch):
    """A symmetric file in REPRO_MATRIX_DIR: its lower triangle, as the
    reference reads it; a name the directory lacks still falls back."""
    from repro.sparse import io as ref_io
    header, size, entries, _ = FILES["gz"]
    _mtx(tmp_path / ("torso2.mtx.gz" if gz else "torso2.mtx"), header, size,
         entries, compress=gz)
    monkeypatch.setenv("REPRO_MATRIX_DIR", str(tmp_path))
    got = sio.load_named("torso2")
    _csr_equal(got, ref_io.load_named("torso2"))
    assert got.shape == (4, 4) and np.allclose(np.triu(got.to_dense(), 1), 0)
    _csr_equal(sio.load_named("lung2"), generators.lung2_like())
    # a zero on the lower triangle's diagonal is refused, as the reference
    _mtx(tmp_path / "lung2.mtx", "real general", "2 2 1", ["2 1 1.0"])
    with pytest.raises(ValueError, match="zero diagonal"):
        sio.load_named("lung2")
    assert isinstance(got, CSR)
