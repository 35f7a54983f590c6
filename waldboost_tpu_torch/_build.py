"""Build the CUDA kernels at first use, load them with ctypes, and launch
and count them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface under ``waldboost_tpu_torch/_build/``;
the file name carries a hash of the source, of the shared headers
(``csrc/*.cuh``) and of the compile flags, so an edited source or header
is rebuilt and an unchanged one is loaded as built.  Each
C entry point takes its pointers as ``void*``, the CUDA stream last, and
returns ``cudaGetLastError()`` after its launch.

Every wrapper under ``ops/`` calls its kernel the same way: :func:`on_card`
picks the plain-torch version (a CPU tensor) or the kernel (a CUDA
tensor), :func:`entry` gives the C function with its signature declared,
and :func:`launch` calls it on the current stream of the tensor's device,
raises on its error and adds 1 to :data:`launches` under the kernel's
name.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "load_library",
           "build_log", "check", "entry", "launch", "launches", "on_card"]

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

#: kernel launches by kernel name (``planes``, ``grad_hist``,
#: ``grad_hist_float``, ``grad_hist_fast``, ``fpga``, ``cascade``,
#: ``cascade_fast``, ``cascade_response``, ``cascade_generic``,
#: ``cascade_suffix``, ``compact``, ``nms``, ``octaves``), from every
#: caller; B3f's launches also by how its front read the canvas
#: (``cascade_fast/tma``, ``cascade_fast/global``, ``cascade_fast/none``),
#: and S2's with the box epilogue of the dense extraction also as
#: ``compact/boxes``
launches: collections.Counter = collections.Counter()


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
    lib = os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")
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


def entry(source: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C function ``symbol`` of the library loaded for
    ``csrc/<source>.cu``, its signature declared once per library object
    (a library swapped into ``_LIBS`` is declared at its first use)."""
    fn = getattr(load_library(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Call the C entry ``fn`` with ``args`` and the current stream of
    ``device`` last, on that device; raise on its error and count the
    launch in :data:`launches` under ``name``."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(err, f"{name} kernel")
    launches[name] += 1


def on_card(tensor: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU tensor (the
    plain version); ValueError naming ``what`` on any other device."""
    kind = tensor.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {tensor.device}")
