"""Build and load the port's CUDA kernels at first use.

Each source under `kernels/csrc/` is compiled by `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface and loaded with
`ctypes`; no PyTorch headers are involved, so a build takes seconds.  The
library goes into `build/kernels/` at the repository root (listed in
`.gitignore`), named by a hash of its source, so an edited source is
rebuilt and an unchanged one is reused.  A failed build raises with the
compiler's output: there is no fallback to the plain version.
`entry_points` binds a library's C functions once, with their argument
types, so that launches from several threads never configure a shared
ctypes function object again.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import uuid
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "build_library",
           "load_library", "entry_points"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.RLock()
_LOADED: dict = {}
_BOUND: dict = {}


def nvcc_path() -> str:
    """nvcc from PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built on the machine with the card")


def build_library(name: str) -> Path:
    """Compile `csrc/<name>.cu` into `build/kernels/lib<name>-<hash>.so`
    unless that file exists; returns its path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # unique temporary name, published by an atomic rename: two processes
    # building the same source never load a half-written library
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}-{uuid.uuid4().hex[:8]}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(str(build_library(name)))
        return lib


def entry_points(name: str, signatures: dict) -> dict:
    """The C functions of `csrc/<name>.cu` named in `signatures` (function
    name -> argtypes), each returning an int error code: {name: function}.
    Their `argtypes`/`restype` are set once, when the library is first
    bound; every later call returns the same functions."""
    with _LOCK:
        fns = _BOUND.get(name)
        if fns is None:
            lib = load_library(name)
            fns = {}
            for fn_name, argtypes in signatures.items():
                fn = getattr(lib, fn_name)
                fn.restype = ctypes.c_int
                fn.argtypes = list(argtypes)
                fns[fn_name] = fn
            _BOUND[name] = fns
        return fns
