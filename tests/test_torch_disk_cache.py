"""The port's disk cache tier, on the CPU.

* The port's cache stays apart from the reference's: in a subprocess that
  blocks `jax` and `repro` on `sys.meta_path` (as
  tests/test_torch_imports.py does), the port is pointed at a directory
  that holds reference entries, one of them under a reference-style name
  carrying the port's own pattern key; it builds, never loads either
  entry, and never imports `repro`.
* The reference's hardening cases on the port's cache
  (tests/test_operator.py:169-210, tests/test_resilience.py:244-306): a
  garbage, truncated or stale entry is quarantined to `.bad/` with a
  `CacheQuarantineWarning` and rebuilt; concurrent writers never tear an
  entry.
* An entry holds host data only, the packed schedules of the SpTRSV
  kernel with their value maps included: a disk hit stages them without
  packing, and a pattern hit refreshes them.

The reference is imported only by the tests that use it, so that the
`cuda` twin runs on a card, which has no JAX.
"""
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.resilience import CacheQuarantineWarning
from repro_torch.kernels import sptrsv_level as K
from repro_torch.solver import TriangularOperator
from repro_torch.solver.operator import (CACHE_VERSION, _payload_packed,
                                         default_cache_dir,
                                         value_fingerprint)
from repro_torch.sparse import generators

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REFINED_RTOL = 1e-8


@pytest.fixture(autouse=True)
def _fresh_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "default"))
    TriangularOperator.clear_memory_cache()
    yield
    TriangularOperator.clear_memory_cache()


def _oracle(L, b):
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular
    M = sp.csr_matrix((L.data, L.indices, L.indptr), shape=L.shape)
    return spsolve_triangular(M, b, lower=True)


def _rel(x, x_ref):
    return np.abs(x - x_ref).max() / max(1.0, np.abs(x_ref).max())


def _entries(d: Path) -> list:
    return sorted(d.glob("torch-op-*.pkl"))


def test_cache_dir_is_the_ports_own(monkeypatch):
    from repro.solver.operator import CACHE_VERSION as REF_CACHE_VERSION
    from repro.solver.operator import default_cache_dir as ref_cache_dir
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", "/somewhere/else")
    assert default_cache_dir() == Path("/somewhere/else")
    monkeypatch.delenv("REPRO_TORCH_CACHE_DIR")
    monkeypatch.delenv("REPRO_CACHE_DIR", raising=False)
    assert default_cache_dir().name == "repro-torch-sptrsv"
    assert default_cache_dir() != ref_cache_dir()
    assert CACHE_VERSION != REF_CACHE_VERSION


def test_port_never_reads_a_reference_entry(tmp_path):
    from repro.solver import TriangularOperator as RefOperator
    from repro.sparse import generators as ref_gen
    L = generators.lung2_like(0.05)
    L_ref = ref_gen.lung2_like(0.05)
    d = tmp_path / "shared"
    RefOperator.from_csr(L_ref, "no_rewriting", cache_dir=d)
    RefOperator.clear_memory_cache()
    (ref_entry,) = d.glob("op-*.pkl")
    # a reference-style name that carries the port's own pattern key: the
    # port's glob must not take it for a base to derive from
    probe = TriangularOperator.from_csr(L, "no_rewriting", device="cpu",
                                        cache=False)
    pkey = TriangularOperator._pattern_cache_key(L, probe._config)
    decoy = d / f"op-{pkey}-{'0' * 16}.pkl"
    decoy.write_bytes(ref_entry.read_bytes())
    before = {p.name: p.read_bytes() for p in d.iterdir()}
    code = f"""
import importlib.abc, sys
import numpy as np
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked import: " + name)
        return None
sys.meta_path.insert(0, Block())
from repro_torch.solver import TriangularOperator
from repro_torch.sparse import generators
L = generators.lung2_like(0.05)
L2 = L.with_data(L.data * 1.5)
for M in (L2, L):
    op = TriangularOperator.from_csr(M, "no_rewriting", device="cpu")
    x = op.solve(np.ones(M.n_rows))
    print(op.stats.cache_source, op.stats.last_residual <= 1e-10)
assert not [m for m in sys.modules if m.split(".")[0] in
            ("jax", "jaxlib", "repro")]
print("clean")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_CACHE_DIR=str(d), REPRO_CACHE_DIR=str(d))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # L2 was built (no pattern base taken from the decoy), L then derived
    # from the port's own entry of L2
    assert proc.stdout.split() == ["built", "True", "pattern", "True",
                                   "clean"]
    assert "Quarantine" not in proc.stderr
    assert not (d / ".bad").exists()
    after = {p.name: p.read_bytes() for p in d.iterdir()
             if not p.name.startswith("torch-op-")}
    assert after == before                       # reference files untouched
    assert len(_entries(d)) == 2


def _built_entry(tmp_path):
    L = generators.lung2_like(0.05)
    kw = dict(tune="no_rewriting", chunk=128, max_deps=8, device="cpu",
              cache_dir=tmp_path)
    op = TriangularOperator.from_csr(L, **kw)
    assert op.stats.cache_source == "built"
    (path,) = _entries(tmp_path)
    return L, kw, path


@pytest.mark.parametrize("mode", ["garbage", "truncate", "stale"])
def test_bad_entries_are_quarantined_and_rebuilt(tmp_path, mode):
    L, kw, path = _built_entry(tmp_path)
    raw = path.read_bytes()
    if mode == "garbage":
        path.write_bytes(b"this is not a pickle")
    elif mode == "truncate":
        path.write_bytes(raw[: max(1, len(raw) // 3)])
    else:
        payload = pickle.loads(raw)
        payload["version"] = "repro_torch-0"
        path.write_bytes(pickle.dumps(payload))
    TriangularOperator.clear_memory_cache()
    match = "stale version" if mode == "stale" else "unreadable"
    with pytest.warns(CacheQuarantineWarning, match=match):
        op = TriangularOperator.from_csr(L, **kw)
    assert op.stats.cache_source == "built"          # rebuilt, no raise
    assert len(list((tmp_path / ".bad").glob("torch-op-*.pkl"))) == 1
    # the rebuilt entry is sound: a clean memory cache hits it on disk
    TriangularOperator.clear_memory_cache()
    op2 = TriangularOperator.from_csr(L, **kw)
    assert op2.stats.cache_source == "disk"
    b = np.random.default_rng(7).standard_normal(L.n_rows)
    assert _rel(op2.solve(b), _oracle(L, b)) < REFINED_RTOL


def test_a_stale_entry_is_no_pattern_base(tmp_path):
    L, kw, path = _built_entry(tmp_path)
    payload = pickle.loads(path.read_bytes())
    payload["version"] = 3                           # the reference's tag
    path.write_bytes(pickle.dumps(payload))
    TriangularOperator.clear_memory_cache()
    with pytest.warns(CacheQuarantineWarning, match="stale version 3"):
        op = TriangularOperator.from_csr(L.with_data(L.data * 2.0), **kw)
    assert op.stats.cache_source == "built"


def test_concurrent_writers_never_tear_the_artifact(tmp_path):
    """Writer threads race on one key while a reader loads in a loop:
    every load is a whole payload of one writer, and no temporary file
    is left."""
    key = "deadbeef" * 4 + "-" + "0" * 16 + "-" + "1" * 16
    stop = threading.Event()
    bad = []

    def payload(tag):
        return {"version": CACHE_VERSION, "tag": tag,
                "blob": np.full(4096, tag, dtype=np.float64)}

    def writer(tag):
        for _ in range(40):
            TriangularOperator._disk_store(key, payload(tag), tmp_path)

    def reader():
        while not stop.is_set():
            got = TriangularOperator._disk_load(key, tmp_path)
            if got is not None and not (got["blob"] == got["tag"]).all():
                bad.append(got)

    threads = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
    rdr = threading.Thread(target=reader)
    rdr.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    rdr.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not rdr.is_alive()
    assert not bad
    assert not list(tmp_path.glob("*.tmp"))
    final = TriangularOperator._disk_load(key, tmp_path)
    assert final is not None and (final["blob"] == final["tag"]).all()


def test_an_entry_carries_the_packed_schedules(tmp_path):
    """What a build on a card persists (it packs before it stores): both
    schedules' packed forms with their value maps, as host arrays, and no
    "_" key.  A disk hit stages them without packing; a pattern hit
    refreshes them."""
    L = generators.lung2_like(0.05)
    kw = dict(tune="avgLevelCost", device="cpu", cache_dir=tmp_path)
    op = TriangularOperator.from_csr(L, **kw)
    for which in ("packed", "preamble_packed"):
        assert _payload_packed(op._payload, which) is not None
    key = (f"{TriangularOperator._pattern_cache_key(L, op._config)}-"
           f"{value_fingerprint(L)}")
    TriangularOperator._disk_store(key, op._payload, tmp_path)
    stored = pickle.loads(TriangularOperator._cache_path(
        key, tmp_path).read_bytes())
    assert not [k for k in stored if k.startswith("_")]
    assert stored["version"] == CACHE_VERSION
    for which in ("packed", "preamble_packed"):
        assert stored[which].tiles.device.type == "cpu"
        np.testing.assert_array_equal(stored[which].values.tile_word,
                                      op._payload[which].values.tile_word)

    TriangularOperator.clear_memory_cache()
    before = dict(K.PACKS)
    hit = TriangularOperator.from_csr(L, **kw)
    assert hit.stats.cache_source == "disk"
    staged = hit._packed("packed")
    assert hit._packed("preamble_packed") is not None
    assert K.PACKS == before                         # nothing packed
    assert torch.equal(staged.tiles, op._payload["packed"].tiles)

    TriangularOperator.clear_memory_cache()
    L2 = L.with_data(L.data * (1.0 + 0.1 * np.cos(np.arange(L.nnz))))
    derived = TriangularOperator.from_csr(L2, **kw)
    assert derived.stats.cache_source == "pattern"
    assert K.PACKS["pack_groups"] == before["pack_groups"]
    assert K.PACKS["refreshes"] == before["refreshes"] + 2
    fresh = K.pack_schedule(derived.schedule)
    for name in ("tiles", "far", "free_dinv"):
        assert torch.equal(getattr(derived._payload["packed"], name),
                           getattr(fresh, name)), name
    b = np.random.default_rng(3).standard_normal(L.n_rows)
    assert _rel(derived.solve(b), _oracle(L2, b)) < REFINED_RTOL


def test_read_only_cache_dir_still_serves(tmp_path):
    target = tmp_path / "not_a_dir"
    target.write_text("a file where the cache directory would go")
    L = generators.chain(32)
    op = TriangularOperator.from_csr(L, "no_rewriting", device="cpu",
                                     cache_dir=target)
    assert op.stats.cache_source == "built"
    assert op.solve(np.ones(32)).shape == (32,)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_disk_hit_packs_nothing(cuda_device, tmp_path):
    L = generators.lung2_like(0.05)
    kw = dict(tune="avgLevelCost", device="cuda", cache_dir=tmp_path)
    built = TriangularOperator.from_csr(L, **kw)
    TriangularOperator.clear_memory_cache()
    before = dict(K.PACKS)
    op = TriangularOperator.from_csr(L, **kw)
    assert op.stats.cache_source == "disk"
    assert K.PACKS["pack_groups"] == before["pack_groups"]
    assert op._payload["packed"].tiles.device.type == "cuda"
    b = np.random.default_rng(5).standard_normal(L.n_rows)
    x_ref = _oracle(L, b)
    assert _rel(op.solve(b, max_refine=0), x_ref) < 5e-4
    assert _rel(op.solve(b), x_ref) < REFINED_RTOL
    assert built.strategy == op.strategy
