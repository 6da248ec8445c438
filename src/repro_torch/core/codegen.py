"""Specialized C-source generator — the analogue of the paper's testbed.

The paper's SpTRSV implementation [12] emits specialized C code per matrix
(Fig. 3/4) and Table I reports "size of code (MB)".  Crucially the prototype
bakes the *numeric* right-hand side into the code: every rewritten row's
b-combination folds to a single constant (Fig. 3 middle/bottom show literal
constants).  That is why torso2's code size stays flat even though rewriting
adds b-side work.  We reproduce the metric exactly the same way: one statement
per row, constants folded against a sample b (default: b = ones), so

    code bytes  ~  f(nnz(A') + n)          — independent of the B' size.

Port of `repro.core.codegen` (numpy only).  The generated code is a metric
artifact and a debugging aid; execution uses the port's level-scheduled
solver.
"""
from __future__ import annotations

import numpy as np

from ..sparse.csr import CSR

__all__ = ["generate_c_source", "generated_code_bytes"]


def _const_row(i: int, c: np.ndarray | None) -> str:
    # folded constant for row i (baked b); without a preamble vector the
    # constant is b[i] itself — emit the literal the paper's codegen would.
    if c is None:
        return f"b{i}_"
    return f"{c[i]:.17g}"


def generate_c_source(A: CSR, c: np.ndarray | None, d: np.ndarray,
                      level_of: np.ndarray,
                      max_rows: int | None = None) -> str:
    """Emit specialized forward-substitution C source, one function per level.

    Row statement (rearranged Lx=b form, paper Fig. 3 middle/bottom):
        x[i] = (CONST - a0*x[c0] - a1*x[c1] ...) / DIAG;
    `c` is the folded preamble constant vector (B'b for a sample b); pass
    None to emit symbolic placeholders.
    """
    n = A.n_rows
    num_levels = int(level_of.max()) + 1 if n else 0
    order = np.lexsort((np.arange(n), level_of))
    out: list[str] = []
    emitted = 0
    pos = 0
    for lvl in range(num_levels):
        out.append(f"void calculate{lvl}(double* x) {{\n")
        while pos < n and level_of[order[pos]] == lvl:
            i = int(order[pos]); pos += 1
            acols, avals = A.row(i)
            terms = "".join(f"-{v:.17g}*x[{int(cc)}]"
                            for cc, v in zip(acols, avals))
            out.append(f"  x[{i}] = ({_const_row(i, c)}{terms})/{d[i]:.17g};\n")
            emitted += 1
            if max_rows is not None and emitted >= max_rows:
                out.append("}\n")
                return "".join(out)
        out.append("}\n")
    return "".join(out)


def generated_code_bytes(A: CSR, c: np.ndarray | None, d: np.ndarray,
                         level_of: np.ndarray) -> int:
    """Byte size of the specialized source, computed without materializing
    one giant string.

    Vectorized: every row statement is scaffold + folded constant + one
    "-%.17g*x[%d]" term per A' entry + "/%.17g;".  Constant and coefficient
    literals are length-estimated at the %.17g average (float64 random values
    format to ~18-19 chars; we use the exact lengths for the index digits and
    a calibrated 19 for value literals — the same estimator is applied to all
    strategies, so Table-I ratios are unaffected).
    """
    n = A.n_rows
    num_levels = int(level_of.max()) + 1 if n else 0
    VAL = 19  # average %.17g literal length for float64
    digits_idx = np.char.str_len(np.arange(n).astype("U"))
    # per-level function scaffolding
    total = sum(len(f"void calculate{lvl}(double* x) {{\n}}\n")
                for lvl in range(num_levels))
    # per-row scaffold: "  x[i] = (" + CONST + ")/" + VAL + ";\n"
    total += int(np.sum(10 + digits_idx + VAL + 2 + VAL + 2))
    # per-entry terms: "-" + VAL + "*x[" + digits(col) + "]"
    if A.nnz:
        total += int(np.sum(1 + VAL + 3 + digits_idx[A.indices] + 1))
    return total
