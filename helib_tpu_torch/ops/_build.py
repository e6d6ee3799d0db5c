"""Build and load the port's CUDA sources (ops/csrc/*.cu).

Each source is compiled by `nvcc` for sm_90a into a shared library with a
plain C interface, loaded with ctypes.  The library lands in
`build/torch_ext/` at the repository root (git-ignored), named by a hash of
its source, the shared headers (csrc/*.cuh) and the flags, so a changed
source or header rebuilds and an unchanged one is reused.  Nothing is
compiled at import time: the first launch builds.  `check_tensors` and
`launch` are the ctypes side that every kernel wrapper shares.

`launch_counts` is the port's one count of its launches, by key: `launch`
adds one under the C entry it calls (`<name>` for helib_<name>_launch,
`<name>_<mode>` for helib_<name>_launch_<mode>), and the transforms that run
no kernel (the staged ones above 2^16, the sharded four-step ones) add
theirs through `count`.  A CUDA-graph replay skips the Python that counts,
so jitutil records a capture's change with `counted_apart` and adds it again
on every replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_ext")
CSRC = os.path.join(_PKG, "ops", "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
ptxas_log: dict = {}     # source name -> nvcc's resource report (this process)
launch_counts: Counter = Counter()   # key -> launches in this process


def count(key: str) -> None:
    """Adds one launch (or transform) under `key`."""
    launch_counts[key] += 1


@contextlib.contextmanager
def counted_apart():
    """Yields a Counter that holds, once the block ends, what the block added
    to `launch_counts`; `launch_counts` itself is left as it was before."""
    before = launch_counts.copy()
    change: Counter = Counter()
    try:
        yield change
    finally:
        change.update(launch_counts - before)
        launch_counts.clear()
        launch_counts.update(before)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _target(name: str) -> tuple[str, str]:
    """(source, library path); the name hashes the source, every shared
    header of csrc/ and the flags, so a changed header rebuilds too."""
    src = os.path.join(CSRC, name + ".cu")
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [src] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
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
    """The loaded library of ops/csrc/<name>.cu, built on first use, with
    the return types of its helib_<name>_launch and helib_cuda_error_string
    set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)[name])
            getattr(lib, f"helib_{name}_launch").restype = ctypes.c_int
            lib.helib_cuda_error_string.restype = ctypes.c_char_p
            lib.helib_cuda_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check_tensors(kernel: str, device, specs) -> None:
    """Raises ValueError unless every (name, tensor, shape) of `specs` is a
    contiguous int32 CUDA tensor of that shape on `device`."""
    for name, t, shape in specs:
        if (not t.is_cuda or t.device != device or t.dtype != torch.int32
                or not t.is_contiguous() or tuple(t.shape) != tuple(shape)):
            raise ValueError(f"{kernel} kernel: {name} must be a contiguous "
                             f"int32 CUDA tensor of shape {tuple(shape)} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def launch(name: str, device, *args, entry: str = "launch") -> None:
    """Calls helib_<name>_<entry> of ops/csrc/<name>.cu with `args` and the
    current stream of `device`: a tensor is passed as its device pointer,
    anything else as the ctypes scalar it is, and counts the launch (see the
    module docstring).  Raises RuntimeError on a CUDA error."""
    lib = load(name)
    cargs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
             else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"helib_{name}_{entry}")(
            *cargs, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.helib_cuda_error_string(err).decode())
    count(name if entry == "launch" else
          name + "_" + entry.removeprefix("launch_"))
