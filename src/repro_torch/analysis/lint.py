"""Repo-rule static lint: the house invariants as an AST pass.

Copy of `repro.analysis.lint`, with the same rules and the same
clock-injected module suffixes, so that it lints `src/repro_torch` (and
`src/repro`) as the reference's lint does.  The conventions it mechanizes
were learned the hard way — host callbacks sneaking into traced loop
bodies, wall-clock reads in logic that is documented clock-injected,
memo writes racing their lock, engines skipping the dtype gate, bare
excepts swallowing typed errors — with nothing but the standard library.
`tests/test_torch_analysis_lint.py` holds `src/repro_torch` clean.

Rules:

  bare-except             `except:` without an exception type — swallows
                          the typed ResilienceError taxonomy and
                          KeyboardInterrupt alike.
  wall-clock              a direct `time.time()/perf_counter()/
                          monotonic()` (or `datetime.now()`) CALL inside a
                          clock-injected module (`CLOCK_INJECTED`): the
                          serving batcher/registry/service and the obs
                          tier take time as an injected `clock`/`now`
                          argument so tests drive them with synthetic
                          clocks.  Referencing `time.perf_counter` as a
                          default value is fine — calling it is not.
  host-callback-in-loop   `jax.pure_callback`/`io_callback` or a host
                          numpy call inside a function passed to
                          `lax.scan` / `lax.while_loop` / `lax.fori_loop`
                          — a host round-trip per traced step, and numpy
                          on traced values is a trace-time crash at best.
  unlocked-memo-mutation  a module- or class-level dict/OrderedDict memo
                          that has a sibling lock is mutated inside a
                          function outside any `with <lock>` block
                          (`TriangularOperator._memory_cache` /
                          `_cache_lock` is the canonical pair).
  require-dtype-gate      a concrete Engine subclass whose `compile()`
                          never calls `_require_dtype` — the capability
                          contract "never a silent dtype fallback".

Per-line suppression: append `# lint: allow=<rule>[,<rule>...]` to the
offending line.  Suppressed findings are reported (and counted) but do
not fail the run.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

__all__ = ["Finding", "RULES", "CLOCK_INJECTED", "lint_source",
           "lint_paths", "render_report"]

RULES = {
    "bare-except": "except: without an exception type",
    "wall-clock": "direct wall-clock call in a clock-injected module",
    "host-callback-in-loop": "pure_callback / host numpy inside a "
                             "jit-traced loop body",
    "unlocked-memo-mutation": "memo/LRU mutated outside its lock",
    "require-dtype-gate": "Engine.compile() without a _require_dtype gate",
}

#: modules (path suffixes) whose logic is documented clock-injected: time
#: enters only as a `now`/`clock` argument so tests can drive them with
#: synthetic clocks (serving/batcher.py module doc, obs tracer/profiler)
CLOCK_INJECTED = (
    "serving/batcher.py", "serving/registry.py", "serving/service.py",
    "obs/trace.py", "obs/metrics.py", "obs/profile.py", "obs/export.py",
)

_WALL_CLOCK_TIME_FNS = {"time", "perf_counter", "monotonic",
                        "process_time", "perf_counter_ns", "monotonic_ns",
                        "time_ns"}
_MUTATOR_METHODS = {"pop", "popitem", "clear", "update", "setdefault",
                    "move_to_end", "append"}
_LOOP_TRACERS = {"scan": (0,), "while_loop": (0, 1), "fori_loop": (2,)}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation (or suppressed would-be violation)."""
    path: str
    line: int
    rule: str
    message: str
    suppressed: bool = False

    def render(self) -> str:
        sup = "  [suppressed]" if self.suppressed else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{sup}"


def _suppressions(src: str) -> dict:
    """line number -> set of rules allowed on that line."""
    out: dict = {}
    marker = "# lint: allow="
    for i, text in enumerate(src.splitlines(), start=1):
        j = text.find(marker)
        if j >= 0:
            rules = text[j + len(marker):].split("#")[0]
            out[i] = {r.strip() for r in rules.split(",") if r.strip()}
    return out


def _attr_chain(node) -> list:
    """`a.b.c` -> ["a", "b", "c"]; non-name bases terminate the chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    parts.reverse()
    return parts


def _is_dict_ctor(node) -> bool:
    if isinstance(node, ast.Dict) and not node.keys:
        return True
    if isinstance(node, ast.Call):
        chain = _attr_chain(node.func)
        return bool(chain) and chain[-1] in ("dict", "OrderedDict")
    return False


def _is_lock_ctor(node) -> bool:
    if isinstance(node, ast.Call):
        chain = _attr_chain(node.func)
        return bool(chain) and chain[-1] in ("Lock", "RLock")
    return False


def _mentions_lock(node) -> bool:
    """Does a with-item expression reference a lock-ish name?"""
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        if name is not None and "lock" in name.lower():
            return True
    return False


class _Aliases:
    """Module-level import aliases for numpy / time / datetime / jax."""

    def __init__(self, tree: ast.Module):
        self.numpy: set = set()
        self.time: set = set()
        self.datetime: set = set()
        self.time_fns: set = set()       # from time import perf_counter
        self.pure_callback: set = set()  # from jax import pure_callback
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    bind = a.asname or a.name.split(".")[0]
                    if a.name == "numpy":
                        self.numpy.add(bind)
                    elif a.name == "time":
                        self.time.add(bind)
                    elif a.name == "datetime":
                        self.datetime.add(bind)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if node.module == "time":
                    for a in node.names:
                        if a.name in _WALL_CLOCK_TIME_FNS:
                            self.time_fns.add(a.asname or a.name)
                elif node.module == "datetime":
                    for a in node.names:
                        if a.name == "datetime":
                            self.datetime.add(a.asname or a.name)
                elif node.module in ("jax", "jax.experimental"):
                    for a in node.names:
                        if a.name in ("pure_callback", "io_callback"):
                            self.pure_callback.add(a.asname or a.name)


def _wall_clock_call(node: ast.Call, al: _Aliases):
    """Name of the wall-clock function if this call reads the clock."""
    f = node.func
    if isinstance(f, ast.Name) and f.id in al.time_fns:
        return f.id
    chain = _attr_chain(f)
    if len(chain) >= 2 and chain[0] in al.time and \
            chain[-1] in _WALL_CLOCK_TIME_FNS:
        return ".".join(chain)
    if len(chain) >= 2 and chain[-1] in ("now", "utcnow", "today") and \
            chain[0] in al.datetime:
        return ".".join(chain)
    return None


def _host_call(node: ast.Call, al: _Aliases):
    """Host-side call (numpy / pure_callback) name, if any."""
    f = node.func
    if isinstance(f, ast.Name) and f.id in al.pure_callback:
        return f.id
    chain = _attr_chain(f)
    if not chain:
        return None
    if chain[-1] in ("pure_callback", "io_callback"):
        return ".".join(chain)
    if chain[0] in al.numpy and len(chain) >= 2:
        return ".".join(chain)
    return None


def _loop_body_args(node: ast.Call):
    """Function-valued operands of a lax.scan/while_loop/fori_loop call."""
    chain = _attr_chain(node.func)
    if not chain or chain[-1] not in _LOOP_TRACERS:
        return
    if len(chain) >= 2 and chain[-2] not in ("lax", "jax"):
        return
    for pos in _LOOP_TRACERS[chain[-1]]:
        if pos < len(node.args):
            yield node.args[pos]
    for kw in node.keywords:
        if kw.arg in ("f", "body_fun", "cond_fun"):
            yield kw.value


def _check_loop_bodies(tree, al, add):
    """host-callback-in-loop: resolve each traced-loop body argument to a
    local def / lambda and scan it for host calls."""
    defs: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node      # last def wins, like the runtime

    def scan_body(fn, loop_line):
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Call):
                host = _host_call(sub, al)
                if host is not None:
                    add(sub.lineno, "host-callback-in-loop",
                        f"`{host}` inside a loop body traced at line "
                        f"{loop_line} runs per traced step on the host")

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        for arg in _loop_body_args(node):
            if isinstance(arg, ast.Lambda):
                scan_body(arg, node.lineno)
            elif isinstance(arg, ast.Name) and arg.id in defs:
                scan_body(defs[arg.id], node.lineno)


def _scope_memos(body) -> tuple:
    """(memo names, has_lock) declared by simple assignments in a module
    or class body."""
    memos, locks = set(), set()
    for stmt in body:
        if isinstance(stmt, ast.Assign):
            targets = [t for t in stmt.targets if isinstance(t, ast.Name)]
            value = stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                and isinstance(stmt.target, ast.Name):
            targets = [stmt.target]
            value = stmt.value
        else:
            continue
        for t in targets:
            if _is_dict_ctor(value):
                memos.add(t.id)
            elif _is_lock_ctor(value) and "lock" in t.id.lower():
                locks.add(t.id)
    return memos, bool(locks)


def _mutation_target(node):
    """The container expression a statement/call mutates, or None."""
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            if isinstance(t, ast.Subscript):
                return t.value
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                return t.value
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in _MUTATOR_METHODS:
            return node.func.value
    return None


def _base_memo_name(node, memos):
    """Memo name if `node` resolves to one: bare NAME, or any
    `<obj>.NAME` attribute access (self/cls/Class qualified)."""
    if isinstance(node, ast.Name) and node.id in memos:
        return node.id
    if isinstance(node, ast.Attribute) and node.attr in memos:
        return node.attr
    return None


def _check_memo_locks(tree, add):
    """unlocked-memo-mutation, for every scope that declares both a
    dict-valued memo and a lock."""
    scopes = [tree] + [n for n in ast.walk(tree)
                       if isinstance(n, ast.ClassDef)]
    memos: set = set()
    for scope in scopes:
        m, has_lock = _scope_memos(scope.body)
        if has_lock:
            memos |= m
    if not memos:
        return

    def visit(node, lock_depth, in_function):
        if isinstance(node, ast.With):
            if any(_mentions_lock(item.context_expr)
                   for item in node.items):
                lock_depth += 1
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            in_function = True
        if in_function and lock_depth == 0:
            target = _mutation_target(node)
            if target is not None:
                name = _base_memo_name(target, memos)
                if name is not None:
                    add(node.lineno, "unlocked-memo-mutation",
                        f"`{name}` is mutated outside its lock")
        for child in ast.iter_child_nodes(node):
            visit(child, lock_depth, in_function)

    visit(tree, 0, False)


def _check_engines(tree, add):
    """require-dtype-gate: concrete Engine subclasses must gate dtypes in
    compile()."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        bases = {chain[-1] for base in node.bases
                 for chain in [_attr_chain(base)] if chain}
        if "Engine" not in bases:
            continue
        for item in node.body:
            if not isinstance(item, ast.FunctionDef) or \
                    item.name != "compile":
                continue
            # an abstract compile (body is just raise/docstring) is exempt
            real = [s for s in item.body
                    if not (isinstance(s, ast.Expr)
                            and isinstance(s.value, ast.Constant))]
            if real and all(isinstance(s, ast.Raise) for s in real):
                continue
            gated = any(
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "_require_dtype"
                for sub in ast.walk(item))
            if not gated:
                add(item.lineno, "require-dtype-gate",
                    f"{node.name}.compile() never calls _require_dtype — "
                    f"silent dtype fallback")


def lint_source(src: str, relpath: str) -> list:
    """Lint one module's source; relpath (posix, repo-relative) scopes the
    module-set rules.  Returns all findings, suppressed ones included."""
    tree = ast.parse(src, filename=relpath)
    allowed = _suppressions(src)
    findings: list = []

    def add(line, rule, message):
        findings.append(Finding(
            path=relpath, line=line, rule=rule, message=message,
            suppressed=rule in allowed.get(line, ())))

    al = _Aliases(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            add(node.lineno, "bare-except",
                "bare `except:` swallows KeyboardInterrupt and the typed "
                "error taxonomy — name the exceptions")
    if relpath.endswith(CLOCK_INJECTED):
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                clock = _wall_clock_call(node, al)
                if clock is not None:
                    add(node.lineno, "wall-clock",
                        f"`{clock}()` called directly in a clock-injected "
                        f"module — take the clock as an argument")
    _check_loop_bodies(tree, al, add)
    _check_memo_locks(tree, add)
    _check_engines(tree, add)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_paths(paths, root=None) -> list:
    """Lint every .py file under `paths` (files or directories).  Paths in
    findings are reported relative to `root` (default: cwd)."""
    root = Path(root) if root is not None else Path.cwd()
    files: list = []
    for p in paths:
        p = Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    findings: list = []
    for f in files:
        try:
            rel = f.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        findings.extend(lint_source(f.read_text(), rel))
    return findings


def render_report(findings) -> str:
    """Human-readable report + summary line."""
    lines = [f.render() for f in findings]
    live = sum(1 for f in findings if not f.suppressed)
    sup = len(findings) - live
    lines.append(f"{live} finding(s), {sup} suppressed")
    return "\n".join(lines)
