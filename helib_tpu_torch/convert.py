"""State carried across from helib_tpu.

Functions that take helib_tpu's state as plain Python values and numpy
uint32 arrays and build this package's objects on a chosen device, plus the
reverse for ciphertext parts.  Nothing here imports helib_tpu: the caller
reads the arrays off its objects (`np.asarray(jax_array)`), e.g.

    ctx = context_from_params(context_params(jctx), device="cuda")
    sk = seckey_from_arrays(ctx, [{"coeffs": ..., "bound": ..., "full": ...}],
                            {key: ksmatrix_arrays(W) for key, W in ...})

A handle is carried as the tuple (powS, powX, keyID).
"""

from __future__ import annotations

import numpy as np

from .context import Context
from .ctxt import Ctxt
from .keys import SecKey, PubKey, KSMatrix, SKHandle
from .ops.modops import to_device, to_host
from .exceptions import InvalidArgument

PARAM_KEYS = ("m", "p", "r", "bits", "c", "scheme", "stdev", "scale")


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
    arr = lambda x: (to_host(x) if hasattr(x, "is_cuda")
                     else np.asarray(x, dtype=np.uint32))
    h = W.from_handle
    return {"from_handle": (h.powS, h.powX, h.keyID),
            "ptxt_space": W.ptxt_space, "b": [arr(x) for x in W.b],
            "a": [arr(x) for x in W.a], "noise": W.noise,
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
                     intFactor: int = 1) -> Ctxt:
    """A Ctxt from parts [(handle, [..., P, N] uint32 array), ...]."""
    return Ctxt(ctx, pubkey, [(_handle(h), to_device(d, ctx.device))
                              for h, d in parts],
                int(k), bool(special), int(ptxt_space), float(noise),
                int(intFactor))


def ctxt_to_arrays(ct: Ctxt) -> list:
    """The reverse: parts as [((powS, powX, keyID), numpy uint32), ...]."""
    return [((h.powS, h.powX, h.keyID), to_host(d)) for h, d in ct.parts]
