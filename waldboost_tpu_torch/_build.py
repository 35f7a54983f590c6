"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface under ``waldboost_tpu_torch/_build/``;
the file name carries a hash of the source, of the shared headers
(``csrc/*.cuh``) and of the compile flags, so an edited source or header
is rebuilt and an unchanged one is loaded as built.  Each
C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "load_library",
           "build_log", "check"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

#: -fmad=false: every float/double multiply and add rounds on its own, as
#: the reference's NumPy arithmetic does (the projection and pool chains
#: are bitwise contracts)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _paths(name: str):
    src = os.path.join(CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every shared header it may include (csrc/*.cuh)
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:16]
    # a source under csrc/baseline/ builds beside the others
    flat = name.replace("/", "_")
    lib = os.path.join(BUILD_DIR, f"lib{flat}_{tag}.so")
    return src, lib, lib[:-3] + ".log"


def build(names) -> None:
    """Compile every ``csrc/<name>.cu`` of ``names`` whose library is
    missing: one nvcc process per source, all started together."""
    jobs = []
    for name in names:
        src, lib, log = _paths(name)
        if os.path.exists(lib):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
                                 src], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((src, lib, log, tmp, proc))
    failed = []
    for src, lib, log, tmp, proc in jobs:
        out, err = proc.communicate()
        try:
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src}:\n{err}")
                continue
            with open(log, "w") as f:
                f.write(out + err)
            os.replace(tmp, lib)  # atomic: concurrent builds agree
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(_paths(name)[1])
    return _LIBS[name]


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    for the current build of ``csrc/<name>.cu``."""
    load_library(name)
    with open(_paths(name)[2]) as f:
        return f.read()


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
