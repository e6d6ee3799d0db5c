"""Build and load the port's CUDA sources (ops/csrc/*.cu).

Each source is compiled by `nvcc` for sm_90a into a shared library with a
plain C interface, loaded with ctypes.  The library lands in `build/torch_ext/`
at the repository root (git-ignored), named by a hash of its source and
flags, so a changed source rebuilds and an unchanged one is reused.  Nothing
is compiled at import time: the first launch builds.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_ext")
CSRC = os.path.join(_PKG, "ops", "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
ptxas_log: dict = {}     # source name -> nvcc's resource report (this process)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    so = f"lib{name}_{digest.hexdigest()[:12]}.so"
    return src, os.path.join(BUILD_DIR, so)


def build(*names: str) -> dict:
    """Compile the named sources that are not built yet, all nvcc processes
    started together; returns {name: path of the shared library}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: _target(name) for name in names}
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)      # one build at a time, any process
        procs = {}
        for name, (src, so) in paths.items():
            if not os.path.exists(so):
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", so + ".tmp", src]
                procs[name] = subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
        failed = []
        for name, proc in procs.items():
            try:
                log, _ = proc.communicate(timeout=900)
            except subprocess.TimeoutExpired:
                for p in procs.values():
                    p.kill()
                raise
            ptxas_log[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{log}")
            else:
                os.replace(paths[name][1] + ".tmp", paths[name][1])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: so for name, (_, so) in paths.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ops/csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name)[name])
        return lib
