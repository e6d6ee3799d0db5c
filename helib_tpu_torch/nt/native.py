"""ctypes bindings for the native C++ host-math kernels (native/).

Role of the reference's NTL/GMP bignum layer at the DoubleCRT::toPoly
boundary (reference src/DoubleCRT.cpp:925-1110): the host CRT combine behind
decryption.  At first use native/crt_kernels.cpp is compiled into
build/torch_ext/ (git-ignored, named by a hash of the source and flags):
with OpenMP where a compiler ($CXX, g++, c++) has it, else serially (its
pragmas are then ignored).  If no compiler builds it, every caller takes the
pure-Python object-int path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np
from ..exceptions import assert_true
from ..ops._build import BUILD_DIR

_HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_HERE, "native", "crt_kernels.cpp")
_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> str | None:
    """The built library's path, compiling it first if needed (one build at
    a time, any process); None if no compiler builds it."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"libhelib_native_{digest.hexdigest()[:12]}"
                      ".so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        if os.path.exists(so):
            return so
        cxxs = dict.fromkeys(c for c in (os.environ.get("CXX"), "g++", "c++")
                             if c)
        for extra in (["-fopenmp"], []):
            for cxx in cxxs:
                try:
                    done = subprocess.run(
                        [cxx, *_FLAGS, *extra, "-o", so + ".tmp", _SRC],
                        capture_output=True, timeout=300).returncode == 0
                except (OSError, subprocess.TimeoutExpired):
                    continue
                if done:
                    os.replace(so + ".tmp", so)
                    return so
    return None


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.crt_init.restype = ctypes.c_void_p
        lib.crt_init.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                 ctypes.c_int]
        lib.crt_free.argtypes = [ctypes.c_void_p]
        lib.crt_nwords.restype = ctypes.c_int
        lib.crt_nwords.argtypes = [ctypes.c_void_p]
        lib.crt_balanced_mod.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64)]
        lib.crt_balanced_limbs.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.crt_balanced_double.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32)]
        lib.crt_mod_switch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class CrtCombiner:
    """Per-prime-set handle around the native CRT kernels.  Cache one per
    rows-tuple (see dcrt.crt_reconstruct)."""

    def __init__(self, qs):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        q = np.ascontiguousarray(np.asarray(qs, dtype=np.uint64))
        self._h = lib.crt_init(
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(q))
        self.W = lib.crt_nwords(self._h)
        self.L = len(q)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.crt_free(h)
            self._h = None

    def _res(self, residues) -> np.ndarray:
        r = np.ascontiguousarray(np.asarray(residues, dtype=np.uint32))
        assert_true(r.ndim == 2 and r.shape[0] == self.L,
                    "residues must be [L, N] for this combiner's primes")
        return r

    def balanced_mod(self, residues, modulus: int) -> np.ndarray:
        """Balanced CRT value mod `modulus` in [0, modulus), [N] int64."""
        r = self._res(residues)
        out = np.empty(r.shape[1], dtype=np.int64)
        self._lib.crt_balanced_mod(
            self._h, r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            r.shape[1], modulus,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out

    def balanced_ints(self, residues) -> np.ndarray:
        """Balanced CRT values as exact Python ints (object array)."""
        r = self._res(residues)
        N = r.shape[1]
        signs = np.empty(N, dtype=np.int8)
        limbs = np.empty((N, self.W), dtype=np.uint64)
        self._lib.crt_balanced_limbs(
            self._h, r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), N,
            signs.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            limbs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        # bulk limbs -> int: one bytes conversion per coefficient
        raw = limbs.tobytes()          # little-endian words, row-major
        stride = 8 * self.W
        out = np.empty(N, dtype=object)
        for j in range(N):
            v = int.from_bytes(raw[j * stride:(j + 1) * stride], "little")
            out[j] = v if signs[j] >= 0 else -v
        return out

    def balanced_float_log2(self, residues):
        """(mantissa, exp2) per coefficient: value = mant * 2^exp2."""
        r = self._res(residues)
        N = r.shape[1]
        mant = np.empty(N, dtype=np.float64)
        ex = np.empty(N, dtype=np.int32)
        self._lib.crt_balanced_double(
            self._h, r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), N,
            mant.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ex.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return mant, ex

    def mod_switch(self, residues, q: int, p2r: int) -> np.ndarray:
        """HElib's rawModSwitch rounding per coefficient (power basis): the
        balanced CRT value c, (X, Y) = divmod(c q, Q) with Y balanced, then
        X + balanced(Y Q^-1 mod p2r), balanced mod q; [N] int64."""
        r = self._res(residues)
        out = np.empty(r.shape[1], dtype=np.int64)
        self._lib.crt_mod_switch(
            self._h, r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            r.shape[1], q, p2r,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out


_combiners: dict = {}


def combiner_for(qs) -> "CrtCombiner | None":
    """Cached CrtCombiner for a prime tuple, or None if natives unavailable."""
    key = tuple(int(q) for q in qs)
    c = _combiners.get(key)
    if c is None and available():
        c = _combiners[key] = CrtCombiner(key)
    return c
