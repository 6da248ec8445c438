"""The port, its examples and chip_smoke.py import neither JAX nor the
JAX package.

An AST scan finds no `jax` and no `repro` import in their sources, and a
subprocess that blocks both on `sys.meta_path` imports every module of
`repro_torch` and every `examples/torch_*.py`, which catches imports that
come in indirectly.
chip_smoke.py exits non-zero, printing no result, without a card and
outside a checkout.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
BLOCKED = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _blocked(name: str) -> bool:
    return name.split(".")[0] in BLOCKED


def test_the_four_examples_are_scanned():
    """The port's examples, five since the training one came."""
    assert [p.name for p in EXAMPLES] == [
        "torch_pcg_ic0.py", "torch_quickstart.py", "torch_timestepping.py",
        "torch_train_lm.py", "torch_transform_study.py"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if _blocked(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_with_jax_and_reference_blocked():
    code = f"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {BLOCKED!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None
sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import importlib.util
for path in {[str(p) for p in EXAMPLES]!r}:
    spec = importlib.util.spec_from_file_location("example", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print(" ".join(names))
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 16
    imported = set(proc.stdout.split()[:-1])
    for name in ("repro_torch.core.portfolio", "repro_torch.obs",
                 "repro_torch.obs.profile", "repro_torch.obs.calibrate",
                 "repro_torch.solver.api", "repro_torch.core.codegen",
                 "repro_torch.sparse.io", "repro_torch.models.mamba2",
                 "repro_torch.models.rglru", "repro_torch.models.encdec",
                 "repro_torch.train", "repro_torch.train.optimizer",
                 "repro_torch.train.data", "repro_torch.train.checkpoint",
                 "repro_torch.train.compression",
                 "repro_torch.train.resilience",
                 "repro_torch.train.train_step",
                 "repro_torch.launch.train"):
        assert name in imported, name


def _run_smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=300)


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict) and ("ok" in obj or "kernels" in obj):
            return True
    return False


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert not _printed_result(proc.stdout)
