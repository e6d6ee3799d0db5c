"""Context: the frozen parameter set + device-resident constant tables
(helib_tpu.context).

Same parameters, prime chain, digit partition and noise helpers as
helib_tpu's Context, for BGV and CKKS, with the tables on an explicit torch
`device`.  The device defaults to "cuda"; on a host without a GPU the
constructor raises unless the caller asks for device="cpu".  `fwd_ntt` and
`inv_ntt` run the fused power-of-2 NTT (ops/ntt_fused.py) for power-of-2 m,
the Bluestein DFT (ops/ntt.py, its convolution in ops/conv.py) for odd m,
whose spectral kernels are transformed on the context's device.  As in
helib_tpu, each (rows, direction) is one compiled program (`jit_call`,
jitutil.py): on the card one CUDA-graph replay a transform, on the host the
eager composition.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .palgebra import PAlgebra
from .exceptions import InvalidArgument
from .nt.primegen import gen_primes, PRIME_BITS
from .ops.ntt import (Pow2NTT, BluesteinTables, aux_tree, aux_primes,
                      bluestein_apply, STAGED_ABOVE, staged_pow2)
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
    # the recryption plaintext space p^(e-e'+r) once RecryptData is built:
    # every key-switching matrix minted after that carries it
    boot_ptxt_space: int = field(default=0, init=False)

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
        self._jits: dict = {}

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

    def primes_of(self, k: int, special: bool, own=None) -> np.ndarray:
        """Primes of a (prefix-k, specials?) prime set, in data-row order;
        `own` (ctxt rows, see rows_of) keeps only those ctxt rows."""
        return self.all_q[np.array(self.rows_of(k, special, own),
                                   dtype=np.int64)]

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
    def dev_q(self, k: int, special: bool, own=None):
        """(q, Barrett mu) of the prime set as [P, 1] int32 device tensors
        (`own`: as in rows_of)."""
        def build():
            qs = self.primes_of(k, special, own)
            return (modops.to_device(qs[:, None], self.device),
                    modops.to_device(modops.barrett_mu(qs)[:, None],
                                     self.device))
        return self.cached(("q", k, special, own), build)

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

    def rows_of(self, k: int, special: bool, own=None) -> tuple:
        """Rows (indices into all_q) of the prime set (k, special): the
        ctxt prefix [0, k), then the special primes.  `own`, a tuple of ctxt
        rows below k, replaces the prefix: the rows one rank of a limb mesh
        holds (parallel/mesh.py), the specials replicated on every rank."""
        rows = list(range(k)) if own is None else list(own)
        if special:
            rows += list(range(self.L, self.L + self.S))
        return tuple(rows)

    def fwd_ntt(self, coeffs, rows: tuple):
        """coeffs [..., P, N] residues (natural order) -> eval domain."""
        return self._transform(coeffs, rows, inverse=False)

    def inv_ntt(self, evals, rows: tuple):
        return self._transform(evals, rows, inverse=True)

    def enable_sharded_transforms(self, A: int, group=None):
        """Route every odd-m transform through the phi(m)-axis-sharded
        four-step Bluestein pipeline (parallel/sharded_ntt.py): the B-point
        convolutions' block axis split A ways over `group` (a
        torch.distributed group whose size divides A; None keeps all A
        blocks here), one exchange per convolution direction and one gather
        that leaves the result replicated for the ring ops around it, which
        every rank runs on the whole ciphertext.  Call after setup and
        keygen; the power-of-2 branch is unchanged, as in helib_tpu."""
        from .parallel.sharded_ntt import ShardedNTT
        sntt = ShardedNTT(aux_primes(), self.ntt_fwd.B, negacyclic=False,
                          A=A, device=self.device)
        if group is not None:
            sntt.set_group(group)
        self._sharded_ntt = sntt

    def disable_sharded_transforms(self):
        self._sharded_ntt = None

    def jit_call(self, key, builder, *args, cache: dict | None = None):
        """helib_tpu's jit sites (Context._ntt_call, dcrt._jit_call): the
        run of builder() for the static configuration `key`, cached in
        `cache` (this context's by default), called on args
        (jitutil.jit_call).  Eager while the sharded transforms are on:
        their gathers go through gloo, which a graph cannot hold."""
        if getattr(self, "_sharded_ntt", None) is not None:
            return builder()(*args)
        from .jitutil import jit_call
        return jit_call(self._jits if cache is None else cache, key, builder,
                        *args)

    def _transform(self, x, rows: tuple, inverse: bool):
        """One compiled program a (rows, direction), as helib_tpu's
        Context._ntt_call."""
        return self.jit_call(("ntt", rows, inverse),
                             lambda: lambda v: self._transform_impl(
                                 v, rows, inverse), x)

    def _transform_impl(self, x, rows: tuple, inverse: bool):
        t = self.ntt_tree(rows)["inv" if inverse else "fwd"]
        if self.pal.pow2:
            if x.shape[-1] > STAGED_ABOVE:
                # no kernel above 2^16, as in helib_tpu (ops/ntt.py)
                return staged_pow2(x, t, inverse)
            from .ops import ntt_fused
            return ntt_fused.ntt(x, t, inverse)
        tab = self.ntt_inv if inverse else self.ntt_fwd
        sntt = getattr(self, "_sharded_ntt", None)
        if sntt is not None:
            from .parallel.sharded_ntt import bluestein_apply_sharded
            return bluestein_apply_sharded(x, t, self.m, tab.B, sntt)
        return bluestein_apply(x, t, self.m, tab.B)

    def __repr__(self):
        return (f"Context(scheme={self.scheme}, m={self.m}, p={self.p}, "
                f"r={self.r}, L={self.L}, S={self.S}, c={self.c}, "
                f"log2Q={self.log2_q(self.L):.1f}, device={self.device}, "
                f"{self.pal!r})")

    def printout(self, file=None):
        """Human-readable parameter dump (reference Context::printout,
        Context.cpp:637); the same text as helib_tpu's."""
        import sys
        from .security import context_security
        f = file or sys.stdout
        pal = self.pal
        print(f"m = {self.m}, p = {self.p}, phi(m) = {self.phi_m}", file=f)
        print(f"  ord(p) = {pal.d}, nslots = {pal.nslots}", file=f)
        print(f"  gens = {pal.gens}, orders = {pal.orders}, "
              f"native = {pal.native}", file=f)
        print(f"  ctxt primes: {self.L} x ~{PRIME_BITS}b "
              f"(log2 Q = {self.log2_q(self.L):.1f})", file=f)
        print(f"  special primes: {self.S} (log2 P = "
              f"{self.log2_special():.1f})", file=f)
        print(f"  digits: {self.digits}", file=f)
        print(f"  security ~= {context_security(self):.1f}", file=f)


def build_context(m: int, p: int = 2, r: int = 1, bits: int = 300, c: int = 3,
                  scheme: str = "bgv", **kw) -> Context:
    """Builder facade (reference ContextBuilder, Context.h:1047-1369); `kw`
    takes the rest of Context's fields, `device` among them."""
    return Context(m=m, p=p, r=r, bits=bits, c=c, scheme=scheme, **kw)
