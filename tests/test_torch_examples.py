"""The port's examples (`examples/torch_*.py`) run on the CPU.

Each example's `main(argv)` runs with `--device cpu` at a small scale and
returns what it printed; the checks are the examples' own (answers against
the float64 oracle `solve_csr_seq`, PCG converged in fewer iterations
than plain CG, value updates that keep the residual at float64's level,
a drifted pattern refused, the code size of the transformed systems, the
LM's loss lower after a simulated failure and a restart).
Tolerances: refined solves within 1e-10 of the oracle (relative to 1), the
float32 gradient within 1e-5 relative to max|g|, float32 unrefined sweeps
within 1e-4 relative to max|x|.  On a card the same mains run in
`chip_smoke.py` without `--device`.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(autouse=True)
def _fresh_caches(tmp_path, monkeypatch):
    from repro_torch.solver import TriangularOperator
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    TriangularOperator.clear_memory_cache()
    yield
    TriangularOperator.clear_memory_cache()


def _main(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def test_quickstart_on_the_cpu(capsys):
    out = _main("quickstart")(["--device", "cpu", "--scale", "0.02"])
    assert out["err"] < 1e-10 and out["err_batched"] < 1e-10
    assert out["err_transpose"] < 1e-10
    assert out["err_grad"] < 1e-5
    assert out["launches"] == {}             # the plain version on the CPU
    assert "tuner pick" in capsys.readouterr().out


def test_pcg_ic0_on_the_cpu():
    out = _main("pcg_ic0")(["--device", "cpu", "--grid", "10"])
    for tune in ("no_rewriting", "avgLevelCost", "auto"):
        assert out[tune]["iters"] < out["base_iters"]
        assert out[tune]["err"] < 1e-5
    assert out["batched_converged"]


def test_timestepping_on_the_cpu():
    out = _main("timestepping")(["--device", "cpu", "--n", "300",
                                 "--grid", "10"])
    assert len(out["residuals"]) == 4 and max(out["residuals"]) < 1e-10
    assert len(out["pcg_iters"]) == 3 and max(out["pcg_iters"]) < 100
    assert out["drift_rejected"]


def test_transform_study_on_the_cpu(capsys):
    out = _main("transform_study")(["--device", "cpu", "--scale", "0.02"])
    assert len(out) == 10
    for (name, strategy), row in out.items():
        assert row["code_MB"] > 0, (name, strategy)
        assert row["err"] < 1e-4, (name, strategy)
    assert "code" in capsys.readouterr().out


def test_train_lm_on_the_cpu(capsys):
    out = _main("train_lm")(["--device", "cpu", "--steps", "24",
                             "--batch", "4", "--seq", "32"])
    assert out["resumed_last"] < out["first"]
    # checkpoints every 4 steps, a failure after step 11: the restart
    # resumes from the one saved after step 8 and runs steps 9-23
    assert out["resumed_steps"] == 15
    text = capsys.readouterr().out
    assert "resumed from step" in text and "OK: loss improved" in text
