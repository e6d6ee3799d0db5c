"""State carried across from helib_tpu.

Functions that take helib_tpu's state as plain Python values and numpy
uint32 arrays and build this package's objects on a chosen device, plus the
reverse for ciphertext parts.  Nothing here imports helib_tpu: the caller
reads the arrays off its objects (`np.asarray(jax_array)`), e.g.

    ctx = context_from_params(context_params(jctx), device="cuda")
    sk = seckey_from_arrays(ctx, [{"coeffs": ..., "bound": ..., "full": ...}],
                            {key: ksmatrix_arrays(W) for key, W in ...})

A handle is carried as the tuple (powS, powX, keyID); a CKKS scale as a
Fraction.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from .context import Context
from .ctxt import Ctxt
from .keys import SecKey, PubKey, KSMatrix, SKHandle
from .ops.modops import to_device, to_host
from .exceptions import InvalidArgument

PARAM_KEYS = ("m", "p", "r", "bits", "c", "scheme", "stdev", "scale",
              "mvec")


def context_params(ctx) -> dict:
    """The parameters of a Context-like object (either package's) plus its
    prime chain as numpy arrays."""
    out = {k: getattr(ctx, k) for k in PARAM_KEYS}
    out["qs"] = np.asarray(ctx.qs, dtype=np.uint32)
    out["sp"] = np.asarray(ctx.sp, dtype=np.uint32)
    return out


def context_from_params(params: dict, device="cuda") -> Context:
    """A Context with the same parameters; raises if the rebuilt prime chain
    differs from the carried one (`qs`/`sp`, when given)."""
    ctx = Context(**{k: params[k] for k in PARAM_KEYS if k in params},
                  device=device)
    for name in ("qs", "sp"):
        if name in params and not np.array_equal(
                np.asarray(params[name], dtype=np.uint32), getattr(ctx, name)):
            raise InvalidArgument(f"carried {name} differ from the rebuilt "
                                  "prime chain")
    return ctx


def _handle(h) -> SKHandle:
    return h if isinstance(h, SKHandle) else SKHandle(*h)


def _host(x) -> np.ndarray:
    """A residue tensor of either package as a numpy uint32 array."""
    return (to_host(x) if isinstance(x, torch.Tensor)
            else np.asarray(x, dtype=np.uint32))


def ksmatrix_from_arrays(ctx: Context, from_handle, ptxt_space: int, b, a,
                         noise: float, prg_seed=None,
                         to_key: int = 0) -> KSMatrix:
    """A KSMatrix from its columns b, a (lists of [L+S, N] uint32 arrays)."""
    return KSMatrix(_handle(from_handle), int(ptxt_space),
                    [to_device(x, ctx.device) for x in b],
                    [to_device(x, ctx.device) for x in a],
                    float(noise), prg_seed, int(to_key))


def ksmatrix_arrays(W) -> dict:
    """The fields of a KSMatrix-like object (either package's) as plain
    values and numpy arrays, the keyword arguments of
    `ksmatrix_from_arrays`."""
    h = W.from_handle
    return {"from_handle": (h.powS, h.powX, h.keyID),
            "ptxt_space": W.ptxt_space, "b": [_host(x) for x in W.b],
            "a": [_host(x) for x in W.a], "noise": W.noise,
            "prg_seed": W.prg_seed, "to_key": W.to_key}


def seckey_from_arrays(ctx: Context, skeys: list, matrices: dict,
                       rng_state: dict | None = None) -> SecKey:
    """A SecKey from secrets [{"coeffs", "bound", "full"}] and matrices
    {key: ksmatrix_arrays(...)}; `rng_state` (the numpy bit-generator state
    of the source key) makes later keygen continue the same stream."""
    sk = [{"coeffs": np.asarray(s["coeffs"], dtype=np.int64),
           "bound": float(s["bound"]),
           "full": to_device(s["full"], ctx.device)} for s in skeys]
    mats = {key: ksmatrix_from_arrays(ctx, **W) for key, W in matrices.items()}
    return SecKey.restore(ctx, sk, mats, rng_state)


def pubkey_from_arrays(ctx: Context, enc_key: list, enc_noise: float,
                       sk_bound: float, matrices: dict) -> PubKey:
    """A PubKey from its encryption of zero [(handle, [L, N] array), ...];
    `matrices` is shared, as a SecKey's dict is with its PubKey."""
    enc = [(_handle(h), to_device(d, ctx.device)) for h, d in enc_key]
    return PubKey.restore(ctx, enc, float(enc_noise), float(sk_bound),
                          matrices)


def ctxt_from_arrays(ctx: Context, pubkey: PubKey, parts: list, k: int,
                     special: bool, ptxt_space: int, noise: float,
                     intFactor: int = 1, ratFactor=1,
                     ptxtMag: float = 1.0) -> Ctxt:
    """A Ctxt from parts [(handle, [..., P, N] uint32 array), ...] and its
    metadata (ratFactor and ptxtMag: the CKKS scale and magnitude)."""
    return Ctxt(ctx, pubkey, [(_handle(h), to_device(d, ctx.device))
                              for h, d in parts],
                int(k), bool(special), int(ptxt_space), float(noise),
                int(intFactor), Fraction(ratFactor), float(ptxtMag))


def ctxt_to_arrays(ct) -> list:
    """The reverse: parts as [((powS, powX, keyID), numpy uint32), ...]."""
    return [((h.powS, h.powX, h.keyID), _host(d)) for h, d in ct.parts]


def ctxt_arrays(ct) -> dict:
    """The parts and metadata of a Ctxt-like object (either package's),
    the keyword arguments of `ctxt_from_arrays` after ctx and pubkey."""
    return {"parts": ctxt_to_arrays(ct), "k": ct.k, "special": ct.special,
            "ptxt_space": ct.ptxt_space, "noise": ct.noise,
            "intFactor": ct.intFactor,
            "ratFactor": Fraction(getattr(ct, "ratFactor", 1)),
            "ptxtMag": getattr(ct, "ptxtMag", 1.0)}


def recrypt_state(rc, sk) -> dict:
    """The key state of a RecryptData-like object (either package's) and
    its SecKey as plain values and numpy arrays: e, ePrime, the big
    plaintext space, the recryption key's index, every secret (the
    recryption key's coefficients among them), ekey and the key-switching
    matrices, which RecryptData mints at the big space."""
    return {"e": rc.e, "ePrime": rc.ePrime, "big_space": rc.big_space,
            "recrypt_key": rc.recrypt_key,
            "skeys": [{"coeffs": np.asarray(s["coeffs"], dtype=np.int64),
                       "bound": float(s["bound"]), "full": _host(s["full"])}
                      for s in sk.skeys],
            "ekey": ctxt_arrays(rc.ekey),
            "matrices": {key: ksmatrix_arrays(W)
                         for key, W in sk.matrices.items()}}


def load_recrypt_state(rc, sk: SecKey, state: dict):
    """Puts a carried key state (`recrypt_state`) into this package's
    RecryptData `rc` and its SecKey: the secrets, the matrices (in place,
    so the PubKey that shares them sees them) and ekey.  The maps are
    deterministic in the slot tables, so `rc` keeps its own."""
    ctx = rc.ctx
    if (rc.e, rc.ePrime, rc.big_space) != (state["e"], state["ePrime"],
                                           state["big_space"]):
        raise InvalidArgument("carried recryption parameters differ")
    ctx.boot_ptxt_space = rc.big_space
    sk.skeys = [{"coeffs": np.asarray(s["coeffs"], dtype=np.int64),
                 "bound": float(s["bound"]),
                 "full": to_device(s["full"], ctx.device)}
                for s in state["skeys"]]
    sk.matrices.clear()
    sk.matrices.update({key: ksmatrix_from_arrays(ctx, **W)
                        for key, W in state["matrices"].items()})
    rc.recrypt_key = int(state["recrypt_key"])
    rc.ekey = ctxt_from_arrays(ctx, sk.pubkey, **state["ekey"])
