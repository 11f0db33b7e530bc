"""Build the port's CUDA kernels (counterpart of
``paddle_tpu/_native_build.py`` ``build_shared_lib``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` — no PyTorch headers, so
a build takes seconds, not minutes.  Libraries land in
``build/paddle_tpu_torch/`` at the repository root (git-ignored),
content-hash keyed (sources, headers and flags), and are installed
atomically through a pid-unique temp file, so concurrent builders never
see a half-written library.  All missing libraries build at once, one
``nvcc`` per source started together.

There is no fallback: if ``nvcc`` is missing or fails, ``BuildError`` is
raised.  Each C entry point returns ``cudaGetLastError()``;
:func:`check` turns a nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "paddle_tpu_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildError(RuntimeError):
    pass


@dataclass
class BuiltKernel:
    """One built library: its path, the ``-Xptxas -v`` report (registers,
    shared memory, spills per kernel) and the build's wall seconds (0 when
    it came from the content-hash cache)."""
    name: str
    path: str
    ptxas: str
    seconds: float


# name -> loaded library.  A cache of immutable loaded code, filled on
# first launch; loading the same path twice would return the same handle.
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise BuildError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                     "port's kernels cannot be built, and there is no "
                     "fallback")


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    if not os.path.exists(src):
        raise BuildError("no kernel source %s" % src)
    h = hashlib.sha256()
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, h.hexdigest()[:16]))


def kernel_names() -> Sequence[str]:
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build(names: Optional[Sequence[str]] = None) -> Dict[str, BuiltKernel]:
    """Build (or find cached) the libraries of ``names`` (default: every
    ``csrc/*.cu``), all missing ones in parallel.  Raises ``BuildError``
    naming every failed source."""
    names = list(names or kernel_names())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out: Dict[str, BuiltKernel] = {}
    procs = {}
    for name in names:
        so = _lib_path(name)
        if os.path.exists(so):
            text = ""
            if os.path.exists(so + ".ptxas.txt"):
                with open(so + ".ptxas.txt") as f:
                    text = f.read()
            out[name] = BuiltKernel(name, so, text, 0.0)
            continue
        tmp = "%s.tmp.%d" % (so, os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (so, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (so, tmp, t0, proc) in procs.items():
        text, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append("%s (exit %d):\n%s" % (name, proc.returncode,
                                                 text))
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        with open(so + ".ptxas.txt", "w") as f:
            f.write(text)
        os.replace(tmp, so)           # atomic: last concurrent builder wins
        out[name] = BuiltKernel(name, so, text, secs)
    if failed:
        raise BuildError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(build([name])[name].path)
    return lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero ``cudaError_t``."""
    if code != 0:
        raise RuntimeError("%s: CUDA launch failed with cudaError %d"
                           % (what, code))
