"""Batched number-theoretic transforms over the RNS limb axis
(helib_tpu.ops.ntt).

  * power-of-2 m : negacyclic radix-2 NTT of size N = m/2;
  * odd m        : full m-point cyclic DFT via Bluestein, with the length-B
                   convolution done exactly over three 30-bit auxiliary primes
                   and CRT'd back mod q.

Tables are built on the host with exact integer numpy, exactly as helib_tpu
builds them, and keep only the natural per-stage layout (`tw`, `tw_sh`,
`itw`, `itw_sh`, `ninv`, `khat`/`khat_sh` as [3, P, B]); the TPU kernels'
coarse/fine relayouts have no counterpart here.  `Pow2NTT.flat()` gives the
same stage tables concatenated into one [P, n] row per prime (stage s at
[2^s, 2^(s+1)), n^-1 at entry 0 of the inverse table), which is what the
CUDA convolution kernel reads.

Transforms run on residue tensors [..., P, n] and keep helib_tpu's output
order (`eval_exponents`): no bit reversal anywhere.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..nt.numbth import root_of_unity, inv_mod
from ..nt.primegen import gen_aux_primes, AUX_POW2
from .modops import (add_mod, sub_mod, mul_mod_shoup, shoup, reduce_u32,
                     to_device, to_host)
from ._build import count
from ..exceptions import assert_true


# ---------------------------------------------------------------------------
# table construction (host, exact ints / uint64 numpy)
# ---------------------------------------------------------------------------

def power_table(r: int, q: int, length: int) -> np.ndarray:
    """[1, r, r^2, ..., r^(length-1)] mod q, vectorized (q < 2^31)."""
    pw = np.array([1], dtype=np.uint64)
    q64 = np.uint64(q)
    while len(pw) < length:
        step = pow(r, len(pw), q)
        pw = np.concatenate([pw, pw * np.uint64(step) % q64])
    return pw[:length].astype(np.uint32)


def _stage_exponents(n: int, e0: int, ord_root: int):
    """Symbolic DIT splitting.  Block i at stage s represents reduction mod
    (X^(n/2^s) - r^E[i]) for a root r of order `ord_root`.  Returns
    (per-stage twiddle exponent lists, final evaluation exponents)."""
    stages = []
    E = [e0]
    while len(E) < n:
        tw = [e // 2 for e in E]
        stages.append(tw)
        E = [x for e in tw for x in (e, e + ord_root // 2)]
    return stages, E


@dataclass
class Pow2NTT:
    """Host tables for a batched radix-2 NTT over primes qs, size n.

    negacyclic=True : ring Z_q[X]/(X^n+1), root psi of order 2n.
    negacyclic=False: cyclic DFT of size n, root omega of order n.
    """
    qs: np.ndarray            # [P] uint32
    n: int
    negacyclic: bool
    tw: list = field(init=False)                    # stage s: [P, 2^s]
    tw_sh: list = field(init=False)
    itw: list = field(init=False)
    itw_sh: list = field(init=False)
    ninv: np.ndarray = field(init=False)            # [P, 1]
    ninv_sh: np.ndarray = field(init=False)
    eval_exponents: np.ndarray = field(init=False)  # [n] exponents of the root
    roots: list = field(init=False)

    def __post_init__(self):
        n = self.n
        qs = np.asarray(self.qs, dtype=np.uint64)
        assert_true(n & (n - 1) == 0, 'invariant: n & (n - 1) == 0')
        ordr = 2 * n if self.negacyclic else n
        e0 = n if self.negacyclic else 0
        stage_exps, eval_exps = _stage_exponents(n, e0, ordr)
        self.eval_exponents = np.array(eval_exps, dtype=np.int64)
        self.roots = [root_of_unity(ordr, int(q)) for q in qs]
        pw = np.stack([power_table(r, int(q), ordr)
                       for r, q in zip(self.roots, qs)])
        self.tw, self.tw_sh, self.itw, self.itw_sh = [], [], [], []
        for exps in stage_exps:
            e = np.array(exps, dtype=np.int64) % ordr
            wt = pw[:, e]
            iwt = pw[:, (-e) % ordr]
            self.tw.append(wt.astype(np.uint32))
            self.tw_sh.append(shoup(wt, qs[:, None]))
            self.itw.append(iwt.astype(np.uint32))
            self.itw_sh.append(shoup(iwt, qs[:, None]))
        self.ninv = np.array([inv_mod(n, int(q)) for q in qs],
                             dtype=np.uint32)[:, None]
        self.ninv_sh = shoup(self.ninv, qs[:, None])

    def flat(self, rows=None) -> dict:
        """The stage tables concatenated per prime: [P, n] each, stage s at
        [2^s, 2^(s+1)); entry 0 is 0 (forward) or n^-1 (inverse).  `rows`
        (indices into qs) keeps only those primes."""
        idx = np.arange(len(self.qs)) if rows is None else np.asarray(rows)
        zero = np.zeros((len(idx), 1), np.uint32)
        cat = lambda first, tabs: np.concatenate(
            [first] + [a[idx] for a in tabs], axis=1)
        return {"tw_all": cat(zero, self.tw),
                "tw_all_sh": cat(zero, self.tw_sh),
                "itw_all": cat(self.ninv[idx], self.itw),
                "itw_all_sh": cat(self.ninv_sh[idx], self.itw_sh)}

    def tree(self, device, lead: int = 0, rows=None) -> dict:
        """Device stage tables (int32 bit patterns), [P, 2^s] for stage s,
        with `lead` unit axes inserted after the prime axis so the transform
        broadcasts over extra dims between P and n.  `rows` (indices into
        qs) keeps only those primes."""
        idx = np.arange(len(self.qs)) if rows is None else np.asarray(rows)

        def dev(a):
            a = a[idx]
            return to_device(a.reshape(a.shape[0], *([1] * lead),
                                       *a.shape[1:]), device)

        qs = np.asarray(self.qs, dtype=np.uint32)[:, None]
        return {"q": dev(qs), "ninv": dev(self.ninv),
                "ninv_sh": dev(self.ninv_sh),
                "tw": [dev(a) for a in self.tw],
                "tw_sh": [dev(a) for a in self.tw_sh],
                "itw": [dev(a) for a in self.itw],
                "itw_sh": [dev(a) for a in self.itw_sh]}


# ---------------------------------------------------------------------------
# staged transforms (plain torch; the reference semantics)
# ---------------------------------------------------------------------------

def ntt_pow2_fwd(x, t):
    """x: [..., P, n] coefficients -> evaluations in `eval_exponents` order."""
    n = x.shape[-1]
    q = t["q"][..., None]  # [.., P, 1, 1]
    for w, ws in zip(t["tw"], t["tw_sh"]):
        m = w.shape[-1]
        half = n // (2 * m)
        xr = x.reshape(*x.shape[:-1], m, 2, half)
        u, v = xr[..., 0, :], xr[..., 1, :]
        wv = mul_mod_shoup(v, w[..., :, None], ws[..., :, None], q)
        y = torch.stack([add_mod(u, wv, q), sub_mod(u, wv, q)], dim=-2)
        x = y.reshape(*y.shape[:-3], n)
    return x


def ntt_pow2_inv(x, t):
    """Inverse of ntt_pow2_fwd (output: natural coefficient order)."""
    n = x.shape[-1]
    q = t["q"][..., None]
    for w, ws in zip(reversed(t["itw"]), reversed(t["itw_sh"])):
        m = w.shape[-1]
        half = n // (2 * m)
        xr = x.reshape(*x.shape[:-1], m, 2, half)
        a, b = xr[..., 0, :], xr[..., 1, :]
        u = add_mod(a, b, q)
        v = mul_mod_shoup(sub_mod(a, b, q), w[..., :, None], ws[..., :, None],
                          q)
        y = torch.stack([u, v], dim=-2)
        x = y.reshape(*y.shape[:-3], n)
    return mul_mod_shoup(x, t["ninv"], t["ninv_sh"], t["q"])


# ---------------------------------------------------------------------------
# Bluestein general-m DFT
# ---------------------------------------------------------------------------

_AUX_CACHE: dict = {}


def aux_primes() -> np.ndarray:
    if "qs" not in _AUX_CACHE:
        _AUX_CACHE["qs"] = np.array(gen_aux_primes(3), dtype=np.uint32)
    return _AUX_CACHE["qs"]


def aux_ntt(B: int) -> Pow2NTT:
    key = ("ntt", B)
    if key not in _AUX_CACHE:
        _AUX_CACHE[key] = Pow2NTT(aux_primes(), B, negacyclic=False)
    return _AUX_CACHE[key]


def aux_spectra(bb: np.ndarray, B: int, device, chunk: int = 64):
    """The staged forward NTT of every row of bb [P, B] mod each auxiliary
    prime, [3, P, B] uint32 on the host; computed on `device` in chunks of
    `chunk` rows (exact modular arithmetic: the same residues wherever it
    runs)."""
    raux = aux_primes().astype(np.uint64)
    t = aux_ntt(B).tree(device, lead=1)
    out = np.empty((3, len(bb), B), dtype=np.uint32)
    for s in range(0, len(bb), chunk):
        b3 = bb[None, s:s + chunk].astype(np.uint64) % raux[:, None, None]
        out[:, s:s + chunk] = to_host(ntt_pow2_fwd(to_device(b3, device), t))
    return out


@dataclass
class BluesteinTables:
    """Per-(prime set, m) host tables for the full-m DFT mod each q in qs;
    `device` is where the spectral kernels khat are transformed."""
    qs: np.ndarray                      # [P]
    m: int
    inverse: bool
    device: torch.device | str = "cpu"
    B: int = field(init=False)
    host: dict = field(init=False)

    def __post_init__(self):
        m = self.m
        qs = np.asarray(self.qs, dtype=np.uint64)
        assert_true(m % 2 == 1, "Bluestein path expects odd m")
        B = 1 << int(np.ceil(np.log2(2 * m - 1)))
        assert_true(B <= (1 << AUX_POW2), 'invariant: B <= (1 << AUX_POW2)')
        self.B = B
        P = len(qs)
        raux = aux_primes().astype(np.uint64)

        u_in = np.empty((P, m), dtype=np.uint32)
        u_out = np.empty((P, m), dtype=np.uint32)
        bb = np.zeros((P, B), dtype=np.uint32)
        inv2 = (m + 1) // 2
        isq = (np.arange(m, dtype=np.int64) ** 2) % m
        for k, q in enumerate(qs):
            q = int(q)
            w = root_of_unity(m, q)
            if self.inverse:
                w = inv_mod(w, q)
            u = pow(w, inv2, q)
            upw = power_table(u, q, m)
            uipw = power_table(inv_mod(u, q), q, m)
            u_in[k] = upw[isq]
            if self.inverse:
                minv = np.uint64(inv_mod(m, q))
                u_out[k] = (u_in[k].astype(np.uint64) * minv % np.uint64(q)
                            ).astype(np.uint32)
            else:
                u_out[k] = u_in[k]
            # kernel bb[d] = u^{-d^2}, wrapped negative indices
            usq_inv = uipw[isq]
            bb[k, :m] = usq_inv
            bb[k, B - m + 1:] = usq_inv[1:][::-1]
        khat = aux_spectra(bb, B, self.device)

        R = int(raux[0]) * int(raux[1]) * int(raux[2])
        Rt = [R // int(r) for r in raux]
        yt_inv = np.array([inv_mod(Rt[t] % int(raux[t]), int(raux[t]))
                           for t in range(3)], dtype=np.uint32)
        Rt_mod_q = np.array([[Rt[t] % int(q) for q in qs] for t in range(3)],
                            dtype=np.uint32)           # [3, P]
        negR_mod_q = np.array([(-R) % int(q) for q in qs], dtype=np.uint32)
        self.host = {
            "q": qs.astype(np.uint32)[:, None],              # [P, 1]
            "u_in": u_in,
            "u_in_sh": shoup(u_in, qs[:, None]),
            "u_out": u_out,
            "u_out_sh": shoup(u_out, qs[:, None]),
            "khat": khat,                                    # [3, P, B]
            "khat_sh": shoup(khat, raux[:, None, None]),
            "Rt_mod_q": Rt_mod_q[:, :, None],                # [3, P, 1]
            "Rt_mod_q_sh": shoup(Rt_mod_q, qs[None, :])[:, :, None],
            "negR": negR_mod_q[:, None],                     # [P, 1]
            "negR_sh": shoup(negR_mod_q, qs)[:, None],
            "yt_inv": yt_inv[:, None, None],                 # [3, 1, 1]
            "yt_inv_sh": shoup(yt_inv, raux)[:, None, None],
        }

    # prime-row tables ([P, ...] or [3, P, ...]); the rest is per aux prime
    _ROW_KEYS = ("q", "u_in", "u_in_sh", "u_out", "u_out_sh", "negR",
                 "negR_sh")
    _AUX_ROW_KEYS = ("khat", "khat_sh", "Rt_mod_q", "Rt_mod_q_sh")

    def tree(self, device, rows, aux: dict) -> dict:
        """Device tables restricted to the prime rows `rows`; `aux` is the
        shared auxiliary-prime table dict (`aux_tree`)."""
        idx = np.asarray(rows)
        out = {k: to_device(self.host[k][idx], device)
               for k in self._ROW_KEYS}
        out.update({k: to_device(self.host[k][:, idx], device)
                    for k in self._AUX_ROW_KEYS})
        out["yt_inv"] = to_device(self.host["yt_inv"], device)
        out["yt_inv_sh"] = to_device(self.host["yt_inv_sh"], device)
        out.update(aux)
        return out


def aux_tree(B: int, device) -> dict:
    """Auxiliary-prime tables shared by every Bluestein tree of size B:
    the staged NTT tables broadcast over the ctxt-prime axis ([3, 1, ...]),
    their flat [3, B] form for the CUDA kernel, and the CRT constants."""
    nttB = aux_ntt(B)
    raux = aux_primes()
    flat = {k: to_device(v, device) for k, v in nttB.flat().items()}
    inv_r = (1.0 / raux.astype(np.float64)).astype(np.float32)
    return {"aux": {**nttB.tree(device, lead=1), **flat},
            "aux_q": to_device(raux[:, None, None], device),     # [3, 1, 1]
            "inv_r_f32": [float(v) for v in inv_r]}


ROW_MAJOR_B = 16384   # the m=8009 class keeps K1's row-major layout

# Above 2^16 there is no kernel (ops/rows.py MAX_LOG_N), as helib_tpu has no
# Pallas kernel above MAX_PALLAS_N = 65536 (helib_tpu/ops/pallas_ntt.py:57):
# a power-of-2 transform of n > 2^16 (Context._transform) and a Bluestein
# convolution of B > 2^16 (bluestein_apply) run the staged torch transforms
# on the tensor's own device, as helib_tpu/ops/ntt.py:337-339, 360-362 and
# 534-537 do.  This is a dispatch by size; the kernel wrappers still refuse
# n > 2^16.  Each such transform counts under "staged" in
# _build.launch_counts, beside the kernels' launches.
STAGED_ABOVE = 1 << 16


def staged_pow2(x, t, inverse: bool):
    """K2's plain version (ntt_fused.ntt_plain) on x [..., P, n], counted."""
    from .ntt_fused import ntt_plain
    count("staged")
    return ntt_plain(x, t, inverse)


def staged_conv(x, aux, khat, khat_sh):
    """K1's plain version (conv.conv_plain) on x [..., 3, P, B], counted."""
    from .conv import conv_plain
    count("staged")
    return conv_plain(x, aux, khat, khat_sh)


def bluestein_apply(x, t, m: int, B: int):
    """Full-m DFT (per table direction) of x: [..., P, m] -> [..., P, m].

    The staged form of helib_tpu's bluestein_apply: lift onto the three
    auxiliary primes, convolve each row with its spectral kernel (ops.conv:
    the CUDA kernels on a GPU), CRT back mod q.  B = 16384 lifts row-major,
    [..., 3, P, B], for K1; B > 2^16 row-major too, for the staged
    convolution (`staged_conv`), as helib_tpu does above its kernels' size;
    every other B aux-major, [3, ..., P, B], for K3, as helib_tpu's default
    `_aux_shared` dispatch does.  The CRT tail is the same elementwise
    arithmetic on either layout, so all give the staged reference's
    residues bit for bit."""
    from . import conv as convmod
    q = t["q"]
    a = mul_mod_shoup(x, t["u_in"], t["u_in_sh"], q)           # [..., P, m]
    if B == ROW_MAJOR_B or B > STAGED_ABOVE:
        ax, lead = -3, ()
        conv = convmod.conv if B == ROW_MAJOR_B else staged_conv
        a3 = reduce_u32(a.unsqueeze(-3), t["aux_q"])           # [..., 3, P, m]
    else:
        ax, conv, lead = 0, convmod.conv_aux, (1,) * (a.dim() - 2)
        a3 = reduce_u32(a.unsqueeze(0), t["aux_q"].reshape(
            (3,) + lead + (1, 1)))                             # [3, ..., P, m]

    def lay(v):
        """A per-aux-prime table [3, ...] laid out for the lift's axes."""
        return v.reshape(v.shape[:1] + lead + v.shape[1:])

    p = conv(F.pad(a3, (0, B - m)), t["aux"], t["khat"], t["khat_sh"])
    aux_q = lay(t["aux_q"])
    y = mul_mod_shoup(p, lay(t["yt_inv"]), lay(t["yt_inv_sh"]), aux_q)
    # float32 CRT lift floor(sum_t y_t / r_t + 1/4), summed left to right
    yf = y.to(torch.float32)
    s = yf.select(ax, 0) * t["inv_r_f32"][0]
    s = s + yf.select(ax, 1) * t["inv_r_f32"][1]
    s = s + yf.select(ax, 2) * t["inv_r_f32"][2]
    alpha = torch.floor(s + 0.25).to(torch.int32)              # [..., P, B]
    terms = mul_mod_shoup(y, lay(t["Rt_mod_q"]), lay(t["Rt_mod_q_sh"]),
                          q.unsqueeze(0))
    acc = add_mod(add_mod(terms.select(ax, 0), terms.select(ax, 1), q),
                  terms.select(ax, 2), q)
    corr = mul_mod_shoup(alpha, t["negR"], t["negR_sh"], q)
    V = add_mod(acc, corr, q)[..., :m]
    return mul_mod_shoup(V, t["u_out"], t["u_out_sh"], q)
