"""Build the port's native sources into shared libraries with a plain C
interface, loaded with ctypes.

``nvcc`` compiles each CUDA library, and the host C++ compiler (``$CXX``,
else ``c++`` / ``g++`` on PATH) each host library, at first use from the
sources under ``rsvio_tpu_torch/csrc/`` into ``rsvio_tpu_torch/_build/``
(listed in .gitignore). The file name carries a hash of the sources,
compiler and flags, so an edited source rebuilds and an unchanged one loads
the existing library. The build writes to a temporary name and renames, so
concurrent processes never load a half-written file. A failed build raises
``KernelError``; nothing falls back to another implementation.

Nothing here runs at import: the build happens inside the first call that
needs a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# --fmad=false keeps a*b+c as two rounded operations, as the plain PyTorch
# version computes it, so kernel and plain version differ only in the order
# of their sums.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")


# Host libraries (no CUDA): plain C++17, no library beyond the C++ runtime.
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


class KernelError(RuntimeError):
    """A native library failed to build, load or launch: a fault of the
    kernel layer, never of the data it was given."""


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: str
    seconds: float     # compile time; 0.0 when an existing build was loaded
    log: str           # nvcc output (ptxas register / shared-memory report)


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default
    install prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                      "build from source at first use")


def find_cxx() -> str:
    """The host C++ compiler: $CXX, else c++ or g++ on $PATH."""
    cands = [os.environ["CXX"]] if os.environ.get("CXX") else []
    cands += [c for c in (shutil.which("c++"), shutil.which("g++")) if c]
    for c in cands:
        path = c if os.path.isabs(c) else shutil.which(c)
        if path and os.access(path, os.X_OK):
            return path
    raise KernelError("no host C++ compiler found (set CXX); the host "
                      "libraries build from source at first use")


def _build(name: str, sources, compiler: str, flags) -> Built:
    """Compile `sources` (file names under csrc/) with `compiler` and
    `flags` into lib<name>-<hash>.so unless that file exists, and load
    it."""
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    h = hashlib.sha256(" ".join(flags).encode())
    if compiler != "nvcc":
        h.update(os.path.basename(compiler).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(out):
        exe = find_nvcc() if compiler == "nvcc" else compiler
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [exe, *flags, "-o", tmp, *paths]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise KernelError(f"{os.path.basename(exe)} failed "
                              f"({proc.returncode}):\n{log}")
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(out)
    except OSError as e:
        raise KernelError(f"cannot load {out}: {e}") from e
    return Built(lib=lib, path=out, seconds=seconds, log=log)


def build_library(name: str, sources) -> Built:
    """A CUDA library: `sources` compiled by nvcc with NVCC_FLAGS."""
    return _build(name, sources, "nvcc", NVCC_FLAGS)


def build_host_library(name: str, sources) -> Built:
    """A host library: `sources` compiled by the host C++ compiler with
    HOST_FLAGS."""
    return _build(name, sources, find_cxx(), HOST_FLAGS)
