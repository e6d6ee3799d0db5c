"""Serialization: binary and JSON forms of every persistent object
(helib_tpu.io).

The same formats as helib_tpu's, byte for byte, so a file written by one
package reads in the other: a block is the eye-catcher b"HTPU", a 2-byte
version, a 4-byte header length, a JSON header (metadata, the block's tag
and its arrays' shapes) and the raw little-endian uint32 arrays.  Residue
tensors are written from the device through the host; readers put them on
the context's device (`read_context` / `context_from_json` take the device,
"cuda" by default).  A PubKey's KS matrices store only their PRG seed for
the uniform a-columns, which `keys.regen_ks_a` redraws at read time.
"""

from __future__ import annotations

import base64
import io as _io
import json
from fractions import Fraction

import numpy as np

from .context import Context
from .ctxt import Ctxt
from .dcrt import small_coeffs_to_rt
from .exceptions import IOError_
from .keys import SecKey, PubKey, SKHandle, KSMatrix, matrix_key, regen_ks_a
from .ops.modops import to_device, to_host

MAGIC = b"HTPU"
VERSION = 1


def _write_block(f, tag: str, meta: dict, arrays: list[np.ndarray]):
    hdr = dict(meta)
    hdr["_tag"] = tag
    hdr["_arrays"] = [list(a.shape) for a in arrays]
    hb = json.dumps(hdr).encode()
    f.write(MAGIC)
    f.write(VERSION.to_bytes(2, "little"))
    f.write(len(hb).to_bytes(4, "little"))
    f.write(hb)
    for a in arrays:
        f.write(np.ascontiguousarray(a, dtype=np.uint32).tobytes())


def _read_block(f, expect_tag: str):
    magic = f.read(4)
    if magic != MAGIC:
        raise IOError_(f"bad eye-catcher {magic!r}")
    ver = int.from_bytes(f.read(2), "little")
    if ver != VERSION:
        raise IOError_(f"unsupported serialization version {ver}")
    n = int.from_bytes(f.read(4), "little")
    hdr = json.loads(f.read(n).decode())
    if hdr["_tag"] != expect_tag:
        raise IOError_(f"expected {expect_tag!r} record, found "
                       f"{hdr['_tag']!r}")
    arrays = []
    for shape in hdr["_arrays"]:
        cnt = int(np.prod(shape)) if shape else 1
        arrays.append(np.frombuffer(f.read(4 * cnt), dtype=np.uint32)
                      .reshape(shape))
    return hdr, arrays


def _handle(h: SKHandle) -> list:
    return [h.powS, h.powX, h.keyID]


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------

def context_meta(ctx: Context) -> dict:
    return {"m": ctx.m, "p": ctx.p, "r": ctx.r, "bits": ctx.bits,
            "c": ctx.c, "scheme": ctx.scheme, "stdev": ctx.stdev,
            "scale": ctx.scale}


def write_context(f, ctx: Context):
    _write_block(f, "Context", context_meta(ctx), [ctx.qs, ctx.sp])


def read_context(f, device="cuda") -> Context:
    """A Context rebuilt from its parameters on `device`; raises unless
    the rebuilt prime chain is the written one."""
    hdr, arrays = _read_block(f, "Context")
    hdr.pop("_tag"), hdr.pop("_arrays")
    ctx = Context(**hdr, device=device)
    if not np.array_equal(ctx.qs, arrays[0]):
        raise IOError_("prime chain mismatch on Context read")
    if not np.array_equal(ctx.sp, arrays[1]):
        raise IOError_("special prime mismatch on Context read")
    return ctx


def context_to_json(ctx: Context) -> str:
    d = context_meta(ctx)
    d["qs"] = [int(q) for q in ctx.qs]
    d["sp"] = [int(q) for q in ctx.sp]
    return json.dumps(d)


def context_from_json(s: str, device="cuda") -> Context:
    d = json.loads(s)
    qs = d.pop("qs")
    d.pop("sp")
    ctx = Context(**d, device=device)
    if [int(q) for q in ctx.qs] != qs:
        raise IOError_("prime chain mismatch on JSON Context read")
    return ctx


# ---------------------------------------------------------------------------
# Ctxt
# ---------------------------------------------------------------------------

def _ctxt_meta(ct: Ctxt) -> dict:
    rf = Fraction(ct.ratFactor)
    return {"k": ct.k, "special": ct.special, "ptxt_space": ct.ptxt_space,
            "noise": ct.noise, "intFactor": ct.intFactor,
            "ratFactor": [str(rf.numerator), str(rf.denominator)],
            "ptxtMag": ct.ptxtMag}


def _ctxt(ctx: Context, pubkey: PubKey, parts: list, d: dict) -> Ctxt:
    num, den = d["ratFactor"]
    return Ctxt(ctx, pubkey, parts, d["k"], d["special"], d["ptxt_space"],
                d["noise"], d["intFactor"], Fraction(int(num), int(den)),
                d["ptxtMag"])


def write_ctxt(f, ct: Ctxt):
    meta = _ctxt_meta(ct)
    meta["handles"] = [_handle(h) for h, _ in ct.parts]
    _write_block(f, "Ctxt", meta, [to_host(d) for _, d in ct.parts])


def read_ctxt(f, ctx: Context, pubkey: PubKey) -> Ctxt:
    hdr, arrays = _read_block(f, "Ctxt")
    parts = [(SKHandle(*h), to_device(a, ctx.device))
             for h, a in zip(hdr["handles"], arrays)]
    return _ctxt(ctx, pubkey, parts, hdr)


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def write_seckey(f, sk: SecKey):
    arrays = [np.asarray(k["coeffs"] % (1 << 32), dtype=np.uint32)
              for k in sk.skeys]
    _write_block(f, "SecKey",
                 {"sk_bounds": [k["bound"] for k in sk.skeys]}, arrays)


def read_seckey(f, ctx: Context) -> SecKey:
    """The secrets, transformed onto ctx's device; no matrices (they come
    with the PubKey), and a keygen RNG seeded with 0, as helib_tpu's."""
    hdr, arrays = _read_block(f, "SecKey")
    bounds = hdr.get("sk_bounds") or [hdr["sk_bound"]]
    skeys = []
    for raw, bound in zip(arrays, bounds):
        coeffs = raw.astype(np.int64)
        coeffs[coeffs > (1 << 31)] -= (1 << 32)
        skeys.append({"coeffs": coeffs, "bound": bound,
                      "full": small_coeffs_to_rt(ctx, coeffs, ctx.L, True)})
    return SecKey.restore(ctx, skeys, {},
                          np.random.default_rng(0).bit_generator.state)


def write_pubkey(f, pk: PubKey, include_matrices: bool = True):
    meta = {"enc_noise": pk.enc_noise, "sk_bound": pk.sk_bound,
            "handles": [_handle(h) for h, _ in pk.enc_key],
            "matrices": []}
    arrays = [to_host(d) for _, d in pk.enc_key]
    if include_matrices:
        for W in pk.matrices.values():
            meta["matrices"].append(
                {"from": _handle(W.from_handle),
                 "ptxt_space": W.ptxt_space, "noise": W.noise,
                 "ncols": len(W.b), "prg_seed": W.prg_seed,
                 "to_key": W.to_key})
            arrays += [to_host(b) for b in W.b]
            # the a-columns only when no PRG seed regenerates them
            if W.prg_seed is None:
                arrays += [to_host(a) for a in W.a]
    _write_block(f, "PubKey", meta, arrays)


def read_pubkey(f, ctx: Context, sk: SecKey | None = None) -> PubKey:
    """A PubKey whose matrices are the evaluation key; given the SecKey it
    belongs to, both share one matrix dict, as PubKey(sk) does."""
    hdr, arrays = _read_block(f, "PubKey")
    nenc = len(hdr["handles"])
    enc = [(SKHandle(*h), to_device(a, ctx.device))
           for h, a in zip(hdr["handles"], arrays[:nenc])]
    pos = nenc
    matrices = {}
    for mm in hdr["matrices"]:
        nc, seed = mm["ncols"], mm.get("prg_seed")
        b = [to_device(a, ctx.device) for a in arrays[pos:pos + nc]]
        pos += nc
        if seed is None:
            a_ = [to_device(a, ctx.device) for a in arrays[pos:pos + nc]]
            pos += nc
        else:
            a_ = regen_ks_a(ctx, seed, nc)
        h, to_key = SKHandle(*mm["from"]), mm.get("to_key", 0)
        matrices[matrix_key(h, to_key)] = KSMatrix(
            h, mm["ptxt_space"], b, a_, mm["noise"], seed, to_key)
    if sk is not None:
        sk.matrices.update(matrices)
        matrices = sk.matrices
    pk = PubKey.restore(ctx, enc, hdr["enc_noise"], hdr["sk_bound"],
                        matrices)
    if sk is not None:
        sk.pubkey = pk
    return pk


# ---------------------------------------------------------------------------
# JSON forms (arrays base64-embedded)
# ---------------------------------------------------------------------------

def ctxt_to_json(ct: Ctxt) -> str:
    d = {"type": "Ctxt", **_ctxt_meta(ct)}
    d["parts"] = []
    for h, t in ct.parts:
        a = to_host(t)
        d["parts"].append({"handle": _handle(h), "shape": list(a.shape),
                           "data": base64.b64encode(a.tobytes()).decode()})
    return json.dumps(d)


def ctxt_from_json(s: str, ctx: Context, pubkey: PubKey) -> Ctxt:
    d = json.loads(s)
    if d["type"] != "Ctxt":
        raise IOError_(f"expected Ctxt record, found {d['type']!r}")
    parts = [(SKHandle(*p["handle"]),
              to_device(np.frombuffer(base64.b64decode(p["data"]),
                                      dtype=np.uint32).reshape(p["shape"]),
                        ctx.device))
             for p in d["parts"]]
    return _ctxt(ctx, pubkey, parts, d)


# ---------------------------------------------------------------------------
# byte-level helpers
# ---------------------------------------------------------------------------

def to_bytes(write_fn, *args) -> bytes:
    buf = _io.BytesIO()
    write_fn(buf, *args)
    return buf.getvalue()


def from_bytes(read_fn, data: bytes, *args):
    return read_fn(_io.BytesIO(data), *args)
