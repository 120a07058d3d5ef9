"""Build and load the engine's CUDA kernels.

The sources in ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded with
``ctypes``.  Each ``.cu`` file gets its own ``nvcc`` process, all started
together, and the objects are then linked.  The library lands in the
build directory (``build/repro_torch_kernels/`` at the repository root,
unless :func:`set_build_dir` points elsewhere: the engine's
``compile_cache_dir``), under a name that hashes the sources and flags,
so an edit rebuilds and an unchanged tree reuses the last build.  Nothing
here runs at import time: the first call to :func:`library` builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("reduced_top2.cu", "bma_cost_matrix.cu", "lsa_children.cu",
           "merge_ranks.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # every f32 add and multiply rounds on its own, as in the plain twins
    "--fmad=false",
    "-Xcompiler", "-fPIC",
)

_C_VOID_P = ctypes.c_void_p
_C_LL = ctypes.c_longlong
_C_INT = ctypes.c_int

# argtypes of every exported entry point: pointers and the stream as
# c_void_p (a bare Python int would be cut to 32 bits), sizes as ints
_SIGNATURES: Dict[str, tuple] = {
    "repro_reduced_top2": (_C_VOID_P,) * 5 + (_C_LL, _C_INT, _C_INT, _C_VOID_P),
    "repro_bma_cost_matrix": (_C_VOID_P,) * 9 + (_C_LL,) + (_C_INT,) * 4 + (_C_VOID_P,),
    "repro_lsa_children": (_C_VOID_P,) * 15 + (_C_LL,) + (_C_INT,) * 4 + (_C_VOID_P,),
    "repro_merge_ranks": (_C_VOID_P,) * 4 + (_C_LL, _C_INT, _C_INT, _C_INT, _C_VOID_P),
}

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
# where build() looks for and writes the library, and how often it found
# the library there ("hits") or ran nvcc ("misses"); process-global like
# the loaded library
_CACHE: Dict[str, object] = {"dir": None, "hits": 0, "misses": 0}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """The directory :func:`build` uses: the one set by
    :func:`set_build_dir`, else ``BUILD_DIR``."""
    return BUILD_DIR if _CACHE["dir"] is None else Path(_CACHE["dir"])


def set_build_dir(path: str) -> None:
    """Build into (and load from) ``path``.  A library this process
    already loaded stays loaded: the new directory serves later
    :func:`build` calls, in practice later processes."""
    _CACHE["dir"] = str(path)


def library_path() -> Path:
    return build_dir() / f"librepro_torch_kernels-{_digest()}.so"


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the shared library (if not built yet)."""
    target = library_path()
    if target.exists():
        _CACHE["hits"] += 1
        return target
    _CACHE["misses"] += 1
    nvcc = nvcc_path()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = os.path.join(tmp, name.replace(".cu", ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / name),
                   "-o", obj]
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(obj)
        failures = []
        for name, proc in procs:
            out, _ = proc.communicate()
            if verbose or proc.returncode:
                print(f"[nvcc {name}]\n{out}", flush=True)
            if proc.returncode:
                failures.append(name)
        if failures:
            raise RuntimeError(f"nvcc failed for {failures}")
        tmp_lib = os.path.join(tmp, target.name)
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o",
                               tmp_lib], capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_lib, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use.  The shards of a
    sharded dispatch launch from several threads; the lock makes the first
    of them build and load once while the others wait."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def check(code: int, kernel: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = library().repro_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed at or before its "
                           f"launch: {msg} ({code})")
