"""Context: the frozen parameter set + device-resident constant tables
(helib_tpu.context).

Same parameters, prime chain, digit partition and noise helpers as
helib_tpu's Context, for BGV and CKKS, with the tables on an explicit torch
`device`.  The device defaults to "cuda"; on a host without a GPU the
constructor raises unless the caller asks for device="cpu".  There is no jit
cache: PyTorch runs eagerly, so `fwd_ntt`/`inv_ntt` call the transform
directly -- the fused power-of-2 NTT (ops/ntt_fused.py) for power-of-2 m,
the Bluestein DFT (ops/ntt.py, its convolution in ops/conv.py) for odd m,
whose spectral kernels are transformed on the context's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .palgebra import PAlgebra
from .exceptions import InvalidArgument
from .nt.primegen import gen_primes, PRIME_BITS
from .ops.ntt import Pow2NTT, BluesteinTables, aux_tree, bluestein_apply
from .ops import modops


# ---------------------------------------------------------------------------
# log2-domain magnitude helpers (role of NTL::xdouble noise bounds)
# ---------------------------------------------------------------------------

NEG_INF = float("-inf")


def log2_add(a: float, b: float) -> float:
    """log2(2^a + 2^b), numerically stable."""
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    hi, lo = (a, b) if a >= b else (b, a)
    return hi + math.log2(1.0 + 2.0 ** (lo - hi))


def log2_sum(vals) -> float:
    acc = NEG_INF
    for v in vals:
        acc = log2_add(acc, v)
    return acc


def resolve_device(device) -> torch.device:
    """The torch device for an entry point; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("helib_tpu_torch: no CUDA device is available; "
                           "pass device='cpu' to run on the host")
    return device


# ---------------------------------------------------------------------------

@dataclass
class Context:
    m: int
    p: int                  # plaintext prime (BGV); -1 for CKKS
    r: int = 1              # plaintext space p^r (BGV); CKKS: log2 precision
    bits: int = 300         # target log2 of the full ctxt-prime product
    c: int = 3              # number of key-switching digits/columns
    scheme: str = "bgv"     # "bgv" | "ckks"
    stdev: float = 3.2      # fresh-noise Gaussian stdev
    scale: float = 10.0     # high-probability bound multiplier
    device: torch.device | str = "cuda"
    mvec: tuple | None = None  # factor-aligned hypercube (bootstrappable ctx)

    pal: PAlgebra = field(init=False)
    qs: np.ndarray = field(init=False)       # ctxt primes, [L] uint32
    sp: np.ndarray = field(init=False)       # special primes, [S] uint32
    all_q: np.ndarray = field(init=False)    # concat [L+S]
    digits: list = field(init=False)         # list of (start, end) over ctxt primes
    ntt_fwd: object = field(init=False)
    ntt_inv: object = field(init=False)

    def __post_init__(self):
        if self.scheme not in ("bgv", "ckks"):
            raise InvalidArgument(f"unknown scheme {self.scheme!r}")
        self.device = resolve_device(self.device)
        self.pal = PAlgebra(self.m, self.p if self.scheme == "bgv" else -1,
                            mvec=tuple(self.mvec) if self.mvec else None)
        n_ctxt = max(2, math.ceil(self.bits / (PRIME_BITS - 0.1)))
        # digits partition: c contiguous groups, as equal as possible
        base, rem = divmod(n_ctxt, self.c)
        sizes = [base + (1 if i < rem else 0) for i in range(self.c)]
        sizes = [s for s in sizes if s > 0]
        bounds, acc = [], 0
        for s in sizes:
            bounds.append((acc, acc + s))
            acc += s
        self.digits = bounds
        n_special = max(e - s for s, e in bounds)
        excl = () if self.scheme == "ckks" else (self.p,)
        primes = gen_primes(self.m, n_ctxt + n_special,
                            exclude=frozenset(excl))
        self.qs = np.array(primes[:n_ctxt], dtype=np.uint32)
        self.sp = np.array(primes[n_ctxt:], dtype=np.uint32)
        self.all_q = np.concatenate([self.qs, self.sp])
        if self.pal.pow2:
            ntt = Pow2NTT(self.all_q, self.pal.n_eval, negacyclic=True)
            self.pal.eval_exponents = ntt.eval_exponents
            self.ntt_fwd = self.ntt_inv = ntt
        else:
            self.ntt_fwd = BluesteinTables(self.all_q, self.m, False,
                                           self.device)
            self.ntt_inv = BluesteinTables(self.all_q, self.m, True,
                                           self.device)
        self._cache: dict = {}

    def cached(self, key, build):
        """Per-context memo of derived constants (tables, digit constants)."""
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    # -- basic getters -----------------------------------------------------
    @property
    def L(self) -> int:
        return len(self.qs)

    @property
    def S(self) -> int:
        return len(self.sp)

    @property
    def ptxt_space(self) -> int:
        return self.p ** self.r

    @property
    def phi_m(self) -> int:
        return self.pal.phi_m

    @property
    def n_eval(self) -> int:
        return self.pal.n_eval

    def log2_q(self, k: int) -> float:
        """log2 of the product of the first k ctxt primes."""
        return float(np.sum(np.log2(self.qs[:k].astype(np.float64))))

    def log2_special(self) -> float:
        return float(np.sum(np.log2(self.sp.astype(np.float64))))

    def prod_qs(self, k: int) -> int:
        v = 1
        for q in self.qs[:k]:
            v *= int(q)
        return v

    def prod_special(self) -> int:
        v = 1
        for q in self.sp:
            v *= int(q)
        return v

    def primes_of(self, k: int, special: bool) -> np.ndarray:
        """Primes of a (prefix-k, specials?) prime set, in data-row order."""
        return np.concatenate([self.qs[:k], self.sp]) if special else self.qs[:k]

    def digit_ranges(self, k: int) -> list[tuple[int, int]]:
        """Digit partition restricted to the live prefix [0, k)."""
        out = []
        for s, e in self.digits:
            s2, e2 = s, min(e, k)
            if s2 < e2:
                out.append((s2, e2))
        return out

    # -- noise model (reference Context.h:475-638, log2 domain) ------------
    def noise_uniform(self, log2_mag: float, deg: int | None = None) -> float:
        deg = self.phi_m if deg is None else deg
        return math.log2(self.scale * math.sqrt(deg / 3.0)) + log2_mag

    def noise_mod(self, modulus: int, deg: int | None = None) -> float:
        deg = self.phi_m if deg is None else deg
        var = modulus * modulus / 12.0
        if modulus % 2 == 0:
            var += 1.0 / 6.0
        return math.log2(self.scale * math.sqrt(deg * var))

    def noise_gaussian(self, sigma: float | None = None,
                       deg: int | None = None) -> float:
        deg = self.phi_m if deg is None else deg
        sigma = self.eff_stdev() if sigma is None else sigma
        return math.log2(self.scale * math.sqrt(deg) * sigma)

    def noise_small(self, prob: float = 0.5, deg: int | None = None) -> float:
        deg = self.phi_m if deg is None else deg
        return math.log2(self.scale * math.sqrt(deg * prob))

    def noise_hwt(self, hwt: int) -> float:
        return math.log2(self.scale * math.sqrt(hwt))

    def eff_stdev(self) -> float:
        """Fresh-error stdev; scaled by sqrt(m) for non-pow2 m."""
        s = self.stdev
        if not self.pal.pow2:
            s *= math.sqrt(self.m)
        return s

    # -- device constant tables -------------------------------------------
    def dev_q(self, k: int, special: bool):
        """(q, Barrett mu) of the prime set as [P, 1] int32 device tensors."""
        def build():
            qs = self.primes_of(k, special)
            return (modops.to_device(qs[:, None], self.device),
                    modops.to_device(modops.barrett_mu(qs)[:, None],
                                     self.device))
        return self.cached(("q", k, special), build)

    def ntt_tree(self, rows: tuple) -> dict:
        """Device transform tables restricted to the given prime rows
        (indices into all_q: ctxt primes are rows [0, L), special primes
        [L, L+S)).  Power-of-2 m: one dict for both directions with the
        stage tables and their flat form (`flat`, for the CUDA kernel);
        odd m: the Bluestein tables of each direction."""
        def build():
            if self.pal.pow2:
                flat = {k: modops.to_device(v, self.device)
                        for k, v in self.ntt_fwd.flat(rows).items()}
                t = {**self.ntt_fwd.tree(self.device, rows=rows),
                     "flat": flat}
                return {"fwd": t, "inv": t}
            aux = self.cached(("aux",), lambda: aux_tree(self.ntt_fwd.B,
                                                         self.device))
            return {"fwd": self.ntt_fwd.tree(self.device, rows, aux),
                    "inv": self.ntt_inv.tree(self.device, rows, aux)}
        return self.cached(("ntt", tuple(rows)), build)

    def rows_of(self, k: int, special: bool) -> tuple:
        rows = list(range(k))
        if special:
            rows += list(range(self.L, self.L + self.S))
        return tuple(rows)

    def fwd_ntt(self, coeffs, rows: tuple):
        """coeffs [..., P, N] residues (natural order) -> eval domain."""
        return self._transform(coeffs, rows, inverse=False)

    def inv_ntt(self, evals, rows: tuple):
        return self._transform(evals, rows, inverse=True)

    def _transform(self, x, rows: tuple, inverse: bool):
        t = self.ntt_tree(rows)["inv" if inverse else "fwd"]
        if self.pal.pow2:
            from .ops import ntt_fused
            return ntt_fused.ntt(x, t, inverse)
        tab = self.ntt_inv if inverse else self.ntt_fwd
        return bluestein_apply(x, t, self.m, tab.B)

    def __repr__(self):
        return (f"Context(scheme={self.scheme}, m={self.m}, p={self.p}, "
                f"r={self.r}, L={self.L}, S={self.S}, c={self.c}, "
                f"log2Q={self.log2_q(self.L):.1f}, device={self.device}, "
                f"{self.pal!r})")
