"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``.  Builds
go under ``photon_ml_tpu_torch/_build/<digest>/`` (git-ignored), keyed by a
digest of every source and header and of the flags, so a fresh checkout
builds at first use and an edited source rebuilds.  ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("fused_glm", "soa_newton", "compact_score")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cand.append(found)
    for c in cand:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME unset and nvcc not on PATH); "
                       "the port's kernels are built from source at first use")


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named kernel library that is not built yet, all at once.
    Returns seconds per library built (empty when all were present).
    ptxas's register and spill report goes to ``<name>.ptxas.log``."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        log = open(out_dir / f"{name}.ptxas.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       tmp, log)
    seconds: Dict[str, float] = {}
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, library_path(name))
    if failed:
        msgs = "\n".join(
            f"--- {n} ---\n{(out_dir / f'{n}.ptxas.log').read_text()[-4000:]}"
            for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return seconds


def ptxas_report(name: str) -> Optional[str]:
    p = build_dir() / f"{name}.ptxas.log"
    return p.read_text() if p.exists() else None


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if it is missing."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    if not library_path(name).exists():
        build_all([name])
    lib = ctypes.CDLL(str(library_path(name)))
    _declare(name, lib)
    _loaded[name] = lib
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    if name == "fused_glm":
        lib.fvg_launch.argtypes = [I, I, P, P, P, P, P, P, L, I, L, I, I, P, P, P]
        lib.fvg_launch.restype = I
        lib.hvp_launch.argtypes = [I, I, P, P, P, P, P, P, P, P, L, I, L, I, I, P, P,
                                   P]
        lib.hvp_launch.restype = I
        lib.glm_smem_bytes.argtypes = [I, I, I]
        lib.glm_smem_bytes.restype = L
    elif name == "soa_newton":
        lib.newton_step_launch.argtypes = [I, I, I, P, P, P, P, P, P, P, I, L, D,
                                           P, P]
        lib.newton_step_launch.restype = I
    elif name == "compact_score":
        lib.match_dot_launch.argtypes = [I, P, P, L, I, P, P, P, L, I, I, I, P, P]
        lib.match_dot_launch.restype = I
    else:
        raise ValueError(f"unknown kernel library {name!r}")
