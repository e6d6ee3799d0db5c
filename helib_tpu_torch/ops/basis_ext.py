"""The RNS basis extension (fast base conversion), on the card in one launch.

`basis_ext(x, tab)` lifts a block of residues x [..., kd, N], on the source
primes d_i (D their product), onto the target moduli of `tab`, the
balanced CRT lift of dcrt:

    y_i   = x_i c_i mod d_i,  c_i = (D/d_i)^-1 mod d_i
    z     = sum_i y_i / d_i (float64, left to right)
    alpha = round(z), halves up
    out   = sum_i y_i (D/d_i) - alpha D mod each target  [..., T, N] int32

and returns (out, frac) with frac = z - alpha [..., N] (float64) when
`want_frac`, else None.  Its callers are the key switch's digit extension
(dcrt._digits) and the scaled mod-down (dcrt._rt_scale_down), which puts
its mod-p^r correction in as one more target row under the modulus p^r.
`basis_ext_tables(d, t, device)` builds the constants once a prime set.

  * `basis_ext_cuda` -- the hand-written kernel csrc/basis_ext.cu, one
    launch; it replaces no TPU kernel: helib_tpu leaves the lift to XLA as
    jnp ops;
  * `basis_ext_plain` -- the same arithmetic as torch ops, a loop over the
    source primes, the version the kernel is held to bit for bit.

`basis_ext` dispatches on where x lies: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes the plain version.  There is no fallback
from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import check_tensors, launch
from .modops import add_mod, mul_mod_shoup, shoup, sub_mod, to_device


def basis_ext_tables(d, t, device) -> dict:
    """The lift's constants from the source primes d (pairwise coprime)
    onto the target moduli t, every one in [2, 2^30): D, `d_q` [kd, 1],
    `c`, `c_sh` [kd, 1] (c_i and its Shoup companion), `inv_d` [kd]
    (float64 1/d_i), `t_q` [T, 1], `M`, `M_sh` [kd, T, 1] (D/d_i mod t_j),
    `D_mod_t`, `D_mod_t_sh` [T, 1]."""
    d = np.asarray(d, dtype=np.uint64)
    t = np.asarray(t, dtype=np.uint64)
    if (d.ndim != 1 or t.ndim != 1 or not d.size or not t.size
            or min(d.min(), t.min()) < 2 or max(d.max(), t.max()) >= 1 << 30):
        raise ValueError("basis_ext: moduli must lie in [2, 2^30)")
    D = 1
    for x in d:
        D *= int(x)
    c_i = np.array([pow((D // int(di)) % int(di), -1, int(di)) for di in d],
                   dtype=np.uint32)
    M = np.array([[(D // int(di)) % int(tj) for tj in t] for di in d],
                 dtype=np.uint32)                         # [kd, T]
    D_mod_t = np.array([D % int(tj) for tj in t], dtype=np.uint32)
    dev = lambda a: to_device(a, device)
    return {"D": D,
            "d_q": dev(d.astype(np.uint32)[:, None]),
            "c": dev(c_i[:, None]), "c_sh": dev(shoup(c_i, d)[:, None]),
            "inv_d": torch.from_numpy(1.0 / d.astype(np.float64)).to(device),
            "t_q": dev(t.astype(np.uint32)[:, None]),
            "M": dev(M[:, :, None]),
            "M_sh": dev(shoup(M, t[None, :])[:, :, None]),
            "D_mod_t": dev(D_mod_t[:, None]),
            "D_mod_t_sh": dev(shoup(D_mod_t, t)[:, None])}


def _shape(x, tab) -> tuple[int, int]:
    kd, T = tab["inv_d"].shape[0], tab["t_q"].shape[0]
    if x.dim() < 2 or x.shape[-2] != kd or x.dtype != torch.int32:
        raise ValueError(f"basis_ext: x must be int32 [..., {kd}, N], got "
                         f"{x.dtype} {tuple(x.shape)}")
    return kd, T


def basis_ext_plain(x, tab, want_frac: bool = False):
    """The lift as torch ops: y, the float64 sum z over the source rows,
    then one Shoup product and one modular add a source row over the whole
    [..., T, N] output."""
    _shape(x, tab)
    t_q = tab["t_q"]
    y = mul_mod_shoup(x, tab["c"], tab["c_sh"], tab["d_q"])
    yf = y.to(torch.float64)
    inv_d = tab["inv_d"]
    z = yf[..., 0, :] * inv_d[0]
    for i in range(1, inv_d.shape[0]):
        z = z + yf[..., i, :] * inv_d[i]
    alpha = torch.floor(z)
    alpha = alpha + ((z - alpha) >= 0.5)
    acc = None
    for i in range(inv_d.shape[0]):
        term = mul_mod_shoup(y[..., i:i + 1, :], tab["M"][i],
                             tab["M_sh"][i], t_q)
        acc = term if acc is None else add_mod(acc, term, t_q)
    corr = mul_mod_shoup(alpha.to(torch.int32).unsqueeze(-2), tab["D_mod_t"],
                         tab["D_mod_t_sh"], t_q)
    return sub_mod(acc, corr, t_q), (z - alpha) if want_frac else None


def basis_ext_cuda(x, tab, want_frac: bool = False):
    """The same on the GPU: x int32 [..., kd, N] whose rows are contiguous
    (else it is copied), the tables on x's device.  One launch on the
    current stream."""
    kd, T = _shape(x, tab)
    if not x.is_cuda:
        raise ValueError("basis_ext kernel: x must be a CUDA tensor")
    n = x.shape[-1]
    check_tensors("basis_ext", x.device, [
        ("d_q", tab["d_q"], (kd, 1)), ("c", tab["c"], (kd, 1)),
        ("c_sh", tab["c_sh"], (kd, 1)), ("t_q", tab["t_q"], (T, 1)),
        ("M", tab["M"], (kd, T, 1)), ("D_mod_t", tab["D_mod_t"], (T, 1))])
    inv_d = tab["inv_d"]
    if inv_d.device != x.device or inv_d.dtype != torch.float64:
        raise ValueError("basis_ext kernel: inv_d must be float64 on "
                         f"{x.device}")
    xv = x.reshape(-1, kd, n)
    if xv.stride(-1) != 1 or xv.stride(-2) != n:
        xv = xv.contiguous()
    B = xv.shape[0]
    out = torch.empty(B, T, n, dtype=torch.int32, device=x.device)
    frac = (torch.empty(B, n, dtype=torch.float64, device=x.device)
            if want_frac else None)
    launch("basis_ext", x.device, xv, out,
           ctypes.c_void_p(None) if frac is None else frac,
           ctypes.c_longlong(B), ctypes.c_longlong(xv.stride(0)),
           ctypes.c_int(kd), ctypes.c_int(T), ctypes.c_int(n), tab["d_q"],
           tab["c"], tab["c_sh"], inv_d, tab["t_q"], tab["M"],
           tab["D_mod_t"])
    lead = x.shape[:-2]
    return (out.reshape(*lead, T, n),
            None if frac is None else frac.reshape(*lead, n))


def basis_ext(x, tab, want_frac: bool = False):
    """The lift on x's device: the CUDA kernel for a CUDA tensor, the plain
    torch version for a CPU tensor."""
    if x.is_cuda:
        return basis_ext_cuda(x, tab, want_frac)
    return basis_ext_plain(x, tab, want_frac)
