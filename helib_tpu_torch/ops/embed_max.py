"""The largest value of a real vector's canonical embedding, on the card.

`embed_max(x, tab)` gives, for each row of x [R, n] (float32), the float64
max over j in Z_m^* of |sum_k x_k zeta_m^(jk)|: norms.py `_largest`, the
spectrum max behind the measured noise of a BGV modulus switch
(Ctxt.mod_down_to), for R rows at once.  At odd m a row holds n <= m
coefficients mod X^m - 1 (the port's rows hold m); at a power-of-2 m the
n = m/2 coefficients mod X^n + 1, whose spectrum is the odd exponents, so
one formula serves both rings.

Both versions run one chirp-z (Bluestein) transform of length L = 2^log_l
>= n + m - 1 on the tables of `embed_tables(m, n, device)`, built once an m
on the host in float64 (Context.cached holds them on the context's device):

  * `embed_max_cuda` -- the hand-written kernel csrc/embed_max.cu (three
    launches through the L2 cache, the max fused into the last); it replaces
    no TPU kernel: helib_tpu computes the same max on the host;
  * `embed_max_plain` -- the same transform through torch.fft, the version
    the kernel is held to.

`embed_max` dispatches on where x lies: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes the plain version.  There is no fallback
from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import launch

MAX_LOG_L = 22     # csrc/embed_max.cu kMaxLogL: L1, L2 <= 2^11


def embed_tables(m: int, n: int, device) -> dict:
    """The chirp-z tables of rows of length n at m: `chirp` [n]
    exp(-i pi k^2 / m), `bhat` [L1, L2] the transform of the conjugate
    chirp over -n < t < m with 1/L folded in (bhat[j1, j2] = Bhat[j1 +
    L1 j2] / L), `tw` [L] exp(-2 pi i k / L), `mask` [m] gcd(j, m) == 1;
    complex ones as float64 [..., 2] (re, im)."""
    if not 1 <= n <= m:
        raise ValueError(f"embed_max: a row of {n} coefficients at m={m}")
    log_l = max(1, (n + m - 2).bit_length())     # least 2^log_l >= n + m - 1
    if log_l > MAX_LOG_L:
        raise ValueError(f"embed_max: m={m}, n={n} needs a transform of "
                         f"2^{log_l} points, above 2^{MAX_LOG_L}")
    L = 1 << log_l
    L1 = 1 << (log_l // 2)

    def chirp(t):   # exp(-i pi t^2 / m), t^2 reduced exactly mod 2m
        r = (t.astype(np.int64) ** 2) % (2 * m)
        return np.exp(-1j * np.pi * r / m)

    b = np.zeros(L, dtype=np.complex128)
    t = np.arange(-(n - 1), m)
    b[t % L] = np.conj(chirp(t))
    bhat = np.fft.fft(b) / L
    def as_pairs(z):
        return torch.from_numpy(np.ascontiguousarray(
            np.stack([z.real, z.imag], -1))).to(device)

    return {
        "m": m, "n": n, "log_l": log_l,
        "chirp": as_pairs(chirp(np.arange(n))),
        "bhat": as_pairs(bhat.reshape(L // L1, L1).T),
        "tw": as_pairs(np.exp(-2j * np.pi * np.arange(L) / L)),
        "mask": torch.from_numpy(
            (np.gcd(np.arange(m), m) == 1).astype(np.uint8)).to(device),
    }


def _check_rows(x, tab) -> None:
    if x.dim() != 2 or x.shape[1] != tab["n"] or x.dtype != torch.float32:
        raise ValueError(f"embed_max: x must be float32 [R, {tab['n']}], "
                         f"got {x.dtype} {tuple(x.shape)}")


def embed_max_plain(x, tab):
    """max_j |F(zeta_m^j)| over Z_m^* of each row of x [R, n] (float32) in
    float64: the chirp-z transform through torch.fft."""
    _check_rows(x, tab)
    L = 1 << tab["log_l"]
    c = torch.view_as_complex(tab["chirp"])
    bhat = torch.view_as_complex(tab["bhat"].transpose(0, 1).contiguous())
    a = torch.zeros(x.shape[0], L, dtype=torch.complex128, device=x.device)
    a[:, :tab["n"]] = x.to(torch.float64) * c
    p = torch.fft.ifft(torch.fft.fft(a) * bhat.reshape(L), norm="forward")
    mag = p[:, :tab["m"]].abs()
    return torch.where(tab["mask"].bool(), mag, 0.0).amax(dim=1)


def embed_max_cuda(x, tab):
    """The same on the GPU: x [R, n] float32, contiguous; the tables on x's
    device.  Three launches on the current stream; returns float64 [R]."""
    _check_rows(x, tab)
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError("embed_max kernel: x must be a contiguous CUDA "
                         "tensor")
    for name in ("chirp", "bhat", "tw", "mask"):
        if tab[name].device != x.device:
            raise ValueError(f"embed_max kernel: table {name} is on "
                             f"{tab[name].device}, x on {x.device}")
    R = x.shape[0]
    out = torch.empty(R, dtype=torch.float64, device=x.device)
    work = torch.empty(R, 1 << tab["log_l"], 2, dtype=torch.float64,
                       device=x.device)
    launch("embed_max", x.device, x, out, work, ctypes.c_longlong(R),
           ctypes.c_int(tab["n"]), ctypes.c_int(tab["m"]),
           ctypes.c_int(tab["log_l"]), tab["chirp"], tab["bhat"], tab["tw"],
           tab["mask"])
    return out


def embed_max(x, tab):
    """The spectrum max of each row on x's device: the CUDA kernel for a
    CUDA tensor, the plain torch version for a CPU tensor."""
    if x.is_cuda:
        return embed_max_cuda(x, tab)
    return embed_max_plain(x, tab)
