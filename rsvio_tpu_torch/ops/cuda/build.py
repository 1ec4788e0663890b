"""Build the port's CUDA sources into shared libraries with a plain C
interface, loaded with ctypes.

``nvcc`` compiles each library at first use from the sources under
``rsvio_tpu_torch/csrc/`` into ``rsvio_tpu_torch/_build/`` (listed in
.gitignore). The file name carries a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the existing library. The
build writes to a temporary name and renames, so concurrent processes never
load a half-written file.

Nothing here runs at import: the build happens inside the first call that
needs a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
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
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build from source at first use")


def build_library(name: str, sources) -> Built:
    """Compile `sources` (file names under csrc/) into lib<name>-<hash>.so
    unless that file exists, and load it."""
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(out):
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)
    return Built(lib=ctypes.CDLL(out), path=out, seconds=seconds, log=log)
