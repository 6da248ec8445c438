"""The port's repo-rule lint against the reference's, on the CPU.

The port keeps its own copy of `repro.analysis.lint` (same rules, same
clock-injected module suffixes).  On every snippet of the reference's lint
suite (tests/test_analysis_lint.py) and on both source trees, the two
linters give the same findings; `src/repro_torch` lints clean, with no
`# lint: allow` suppression anywhere in it.
"""
import dataclasses
from pathlib import Path

import pytest
import torch

from repro_torch.analysis.lint import (CLOCK_INJECTED, RULES, Finding,
                                       lint_paths, lint_source,
                                       render_report)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_MEMO_HEADER = ("import threading\n"
                "_CACHE: dict = {}\n"
                "_CACHE_LOCK = threading.RLock()\n\n")

# (source, repo-relative path, the rules it must raise) — the reference
# suite's snippets, and the F1 pattern that obs/profile.py had
SNIPPETS = {
    "bare-except": ("try:\n    x = 1\nexcept:\n    pass\n", "m.py",
                    ["bare-except"]),
    "typed-except": ("try:\n    x = 1\nexcept (ValueError, KeyError):\n"
                     "    pass\n", "m.py", []),
    "wall-clock-batcher": (
        "import time\n\ndef f():\n    return time.perf_counter()\n",
        "src/repro_torch/serving/batcher.py", ["wall-clock"]),
    "wall-clock-outside": (
        "import time\n\ndef f():\n    return time.perf_counter()\n",
        "src/repro_torch/solver/operator.py", []),
    "wall-clock-default": (
        "import time\n\ndef f(clock=time.perf_counter):\n"
        "    return clock()\n", "src/repro_torch/serving/registry.py", []),
    "wall-clock-from-import": (
        "from time import perf_counter\nimport datetime\n\n"
        "def f():\n    return perf_counter()\n\n"
        "def g():\n    return datetime.datetime.now()\n",
        "src/repro_torch/obs/trace.py", ["wall-clock", "wall-clock"]),
    "wall-clock-launch-us": (
        "import time\n\ndef _launch_us(fn, c, launches, calls=20):\n"
        "    t0 = time.perf_counter()\n    for _ in range(calls):\n"
        "        fn(c)\n    return (time.perf_counter() - t0) / calls\n",
        "src/repro_torch/obs/profile.py", ["wall-clock", "wall-clock"]),
    "numpy-in-scan": (
        "import numpy as np\nfrom jax import lax\n\n"
        "def body(carry, t):\n    return carry + np.asarray(t), None\n\n"
        "def run(xs):\n    return lax.scan(body, 0.0, xs)\n", "m.py",
        ["host-callback-in-loop"]),
    "callback-in-fori": (
        "import jax\nfrom jax import lax\n\ndef run(xs):\n"
        "    return lax.fori_loop(0, 3, "
        "lambda i, v: jax.pure_callback(print, None, v), xs)\n", "m.py",
        ["host-callback-in-loop"]),
    "jnp-in-scan": (
        "import jax.numpy as jnp\nfrom jax import lax\n\n"
        "def body(carry, t):\n    return carry + jnp.sin(t), None\n\n"
        "def run(xs):\n    return lax.scan(body, 0.0, xs)\n", "m.py", []),
    "numpy-outside-loop": (
        "import numpy as np\nfrom jax import lax\n\n"
        "def body(c, t):\n    return c + t, None\n\n"
        "def run(xs):\n    xs = np.asarray(xs)\n"
        "    return lax.scan(body, 0.0, xs)\n", "m.py", []),
    "unlocked-memo": (_MEMO_HEADER + "def put(k, v):\n    _CACHE[k] = v\n",
                      "m.py", ["unlocked-memo-mutation"]),
    "locked-memo": (_MEMO_HEADER + "def put(k, v):\n"
                    "    with _CACHE_LOCK:\n        _CACHE[k] = v\n",
                    "m.py", []),
    "memo-method-class-scope": (
        "import threading\nimport collections\n\nclass C:\n"
        "    _memo = collections.OrderedDict()\n"
        "    _lock = threading.Lock()\n\n"
        "    def evict(self):\n        self._memo.popitem(last=False)\n\n"
        "    def ok(self):\n"
        "        with self._lock:\n            self._memo.clear()\n",
        "m.py", ["unlocked-memo-mutation"]),
    "memo-without-lock": (
        "_CHAINS: dict = {}\n\ndef set_chain(k, v):\n    _CHAINS[k] = v\n",
        "m.py", []),
    "import-time-memo-init": (_MEMO_HEADER + "_CACHE['seed'] = 1\n",
                              "m.py", []),
    "engine-without-gate": (
        "class FastEngine(Engine):\n"
        "    def compile(self, dsched):\n        return lambda c: c\n",
        "m.py", ["require-dtype-gate"]),
    "engine-with-gate": (
        "class Engine:\n    def compile(self, dsched):\n"
        "        raise NotImplementedError\n\n"
        "class GatedEngine(Engine):\n    def compile(self, dsched):\n"
        "        self._require_dtype(dsched)\n        return lambda c: c\n",
        "m.py", []),
    "suppressed": ("try:\n    x = 1\nexcept:  # lint: allow=bare-except\n"
                   "    pass\n", "m.py", ["bare-except"]),
    "suppressed-other-rule": (
        "try:\n    x = 1\nexcept:  # lint: allow=wall-clock\n    pass\n",
        "m.py", ["bare-except"]),
}


def _as_tuples(findings):
    return [dataclasses.astuple(f) for f in findings]


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_snippet_findings_equal_the_reference(name):
    from repro.analysis.lint import lint_source as ref_lint_source
    src, path, rules = SNIPPETS[name]
    got = lint_source(src, path)
    assert [f.rule for f in got] == rules
    assert _as_tuples(got) == _as_tuples(ref_lint_source(src, path))


def test_suppression_marks_but_keeps_the_finding():
    src, path, _ = SNIPPETS["suppressed"]
    (f,) = lint_source(src, path)
    assert f.suppressed
    (g,) = lint_source(*SNIPPETS["suppressed-other-rule"][:2])
    assert not g.suppressed


def test_catalogs_and_report_equal_the_reference():
    from repro.analysis import lint as ref_lint
    assert RULES == ref_lint.RULES
    assert CLOCK_INJECTED == ref_lint.CLOCK_INJECTED
    f1 = Finding(path="a.py", line=3, rule="bare-except", message="m")
    f2 = Finding(path="a.py", line=9, rule="wall-clock", message="m",
                 suppressed=True)
    r1 = ref_lint.Finding(path="a.py", line=3, rule="bare-except",
                          message="m")
    r2 = ref_lint.Finding(path="a.py", line=9, rule="wall-clock",
                          message="m", suppressed=True)
    assert render_report([f1, f2]) == ref_lint.render_report([r1, r2])
    assert "1 finding(s), 1 suppressed" in render_report([f1, f2])


@pytest.mark.parametrize("tree", ["repro", "repro_torch"])
def test_both_trees_lint_as_the_reference_lints_them(tree):
    from repro.analysis.lint import lint_paths as ref_lint_paths
    got = lint_paths([REPO / "src" / tree], root=REPO)
    want = ref_lint_paths([REPO / "src" / tree], root=REPO)
    assert _as_tuples(got) == _as_tuples(want)


def test_src_repro_torch_lints_clean_without_suppressions():
    findings = lint_paths([REPO / "src" / "repro_torch"], root=REPO)
    assert not findings, render_report(findings)
    # the lint module itself names the marker; no other file carries one
    lint_py = REPO / "src" / "repro_torch" / "analysis" / "lint.py"
    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        if path != lint_py:
            assert "# lint: allow" not in path.read_text(), path
