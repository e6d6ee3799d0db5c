"""Reader and exporter for HElib's LEGACY BINARY serialization format
(helib_tpu.io_helib_bin).

The reference ships endianness golden fixtures
(tests/test_resources/iotest_bin{LE,BE}.bin, referenced from
tests/CMakeLists.txt:96-99) written by the v1-era binary writers
(misc/legacy_tests/Test_Bin_IO.cpp; primitives in src/binio.cpp:19-145).
This is the format deployed HElib v1 installations exchanged on disk.

Wire format (reverse-engineered against the ASCII twin fixture, which the
same test run wrote from the same objects — iotest_binLE.bin and
iotest_asciiLE.txt contain bit-identical key material):

  * eye catchers: 4-byte tags |BS[ ]BS| |CN[ ]CN| |PK[ ]PK| |SK[ ]SK|
    |CX[ ]CX| |KM[ ]KM|  (src/binio.h:36-53 lists the modern set; the v1
    fixtures use BS for the context base)
  * raw ints: 64-bit little-endian (write_raw_int, binio.cpp:75 — the
    big-endian branch also emits little-endian byte order, which is why
    the BE fixture differs only in payload values, not layout)
  * NTL vec_long: int32 length, int32 intSize (4 or 8), then items
    (write_ntl_vec_long, binio.cpp:103)
  * IndexSet: int64 cardinality + elements
  * xdouble: double mantissa + int64 exponent (write_raw_xdouble)
  * ZZ: int64 byte count + little-endian magnitude (write_raw_ZZ)
  * base |BS[: p, r, m, gens (int64 len + items), ords ]BS|
  * context |CN[: stdev (double), smallPrimes set, ctxtPrimes set,
    nprimes, primes (int64 each), ndigits, digit sets, trailer ]CN|
  * Ctxt |CX[: ptxtSpace, noiseVar (xdouble), primeSet, nparts,
    parts = (DoubleCRT, SKHandle as 3 int64) ]CX|
  * DoubleCRT: IndexSet + one vec_long row per prime (phi(m) wide)
  * KS matrix |KM[: SKHandle, toKeyID, ptxtSpace, ncols, ncols DoubleCRTs
    (the b columns), PRG seed ZZ ]KM|
  * PubKey |PK[: base, pubEncrKey Ctxt, skHwts vec, nmatrices, matrices,
    keySwitchMap trailer ]PK|
  * SecKey |SK[: embedded PubKey, nkeys, per key a full-chain DoubleCRT
    ]SK|

Like io_helib (the text reader), this extracts the fields the
cross-validation tests need into a HelibLegacyDump.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .exceptions import IOError_
from .io_helib import HelibLegacyDump


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.off = 0

    def expect(self, tag: bytes):
        got = self.d[self.off:self.off + 4]
        if got != tag:
            raise IOError_(f"binary parse: expected {tag!r} at "
                           f"{self.off}, got {got!r}")
        self.off += 4

    def skip_to_after(self, tag: bytes):
        j = self.d.find(tag, self.off)
        if j < 0:
            raise IOError_(f"binary parse: closing {tag!r} not found")
        self.off = j + 4

    def i64(self):
        v = struct.unpack_from("<q", self.d, self.off)[0]
        self.off += 8
        return v

    def f64(self):
        v = struct.unpack_from("<d", self.d, self.off)[0]
        self.off += 8
        return v

    def xdouble(self):
        m = self.f64()
        e = self.i64()
        return m * (2.0 ** e) if -900 < e < 900 else m

    def iset(self):
        card = self.i64()
        if not 0 <= card <= 1 << 20:
            raise IOError_(f"binary parse: bad IndexSet card {card}")
        return [self.i64() for _ in range(card)]

    def vec_long(self):
        ln, sz = struct.unpack_from("<ii", self.d, self.off)
        self.off += 8
        if sz not in (4, 8) or not 0 <= ln <= 1 << 24:
            raise IOError_(f"binary parse: bad vec_long header ({ln},{sz})")
        fmt = "<q" if sz == 8 else "<i"
        out = [struct.unpack_from(fmt, self.d, self.off + sz * k)[0]
               for k in range(ln)]
        self.off += sz * ln
        return out

    def i64_vec(self):
        ln = self.i64()
        if not 0 <= ln <= 1 << 20:
            raise IOError_(f"binary parse: bad vector length {ln}")
        return [self.i64() for _ in range(ln)]

    def zz(self):
        nb = self.i64()
        if not 0 < nb <= 1 << 16:
            raise IOError_(f"binary parse: bad ZZ byte count {nb}")
        v = int.from_bytes(self.d[self.off:self.off + nb], "little")
        self.off += nb
        return v

    def dcrt(self):
        s = self.iset()
        rows = [self.vec_long() for _ in s]
        return s, rows


@dataclass
class HelibBinaryKSMatrix:
    handle: tuple          # (powerOfS, powerOfX, keyID)
    to_key: int
    ptxt_space: int
    b_columns: list        # [(prime idx list, rows)]
    prg_seed: int


@dataclass
class HelibBinaryDump(HelibLegacyDump):
    stdev: float = 3.2
    sk_hwts: list = field(default_factory=list)
    ks_matrices: list = field(default_factory=list)
    pub_noise: float = 0.0


def _read_base(r: _Reader):
    r.expect(b"|BS[")
    p, rr, m = r.i64(), r.i64(), r.i64()
    gens = r.i64_vec()
    ords = r.i64_vec()
    r.expect(b"]BS|")
    return m, p, rr, gens, ords


def _read_ctxt(r: _Reader):
    r.expect(b"|CX[")
    pspace = r.i64()
    noise = r.xdouble()
    pset = r.iset()
    nparts = r.i64()
    if not 0 <= nparts <= 16:
        raise IOError_(f"binary parse: bad part count {nparts}")
    parts = []
    for _ in range(nparts):
        s, rows = r.dcrt()
        handle = (r.i64(), r.i64(), r.i64())
        if s != pset:
            raise IOError_("binary parse: ctxt part prime-set mismatch")
        parts.append((handle, list(pset), rows))
    r.expect(b"]CX|")
    return pspace, noise, pset, parts


def _read_ks_matrix(r: _Reader):
    r.expect(b"|KM[")
    handle = (r.i64(), r.i64(), r.i64())
    to_key = r.i64()
    pspace = r.i64()
    ncols = r.i64()
    if not 0 < ncols <= 16:
        raise IOError_(f"binary parse: bad KS column count {ncols}")
    cols = []
    for _ in range(ncols):
        s, rows = r.dcrt()
        cols.append((s, rows))
    seed = r.zz()
    r.expect(b"]KM|")
    return HelibBinaryKSMatrix(handle, to_key, pspace, cols, seed)


def read_binary_dump(path: str) -> HelibBinaryDump:
    with open(path, "rb") as f:
        r = _Reader(f.read())
    m, p, rr, gens, ords = _read_base(r)

    r.expect(b"|CN[")
    stdev = r.f64()
    r.i64_vec()                 # smallPrimes (empty in the fixtures)
    r.i64_vec()                 # ctxtPrimes index set
    nprimes = r.i64()
    if not 0 < nprimes <= 1 << 16:
        raise IOError_(f"binary parse: bad prime count {nprimes}")
    primes = [r.i64() for _ in range(nprimes)]
    # digits + trailer: not needed, scan to the end tag
    r.skip_to_after(b"]CN|")

    r.expect(b"|PK[")
    base2 = _read_base(r)
    if base2 != (m, p, rr, gens, ords):
        raise IOError_("binary parse: PK base disagrees with file base")
    pub_space, pub_noise, _, pub_parts = _read_ctxt(r)
    sk_hwts = r.i64_vec()
    nmat = r.i64()
    if not 0 <= nmat <= 1 << 12:
        raise IOError_(f"binary parse: bad matrix count {nmat}")
    mats = [_read_ks_matrix(r) for _ in range(nmat)]
    r.skip_to_after(b"]PK|")    # keySwitchMap trailer

    r.expect(b"|SK[")
    r.expect(b"|PK[")
    r.off -= 4
    r.skip_to_after(b"]PK|")    # embedded PubKey (same as above)
    nkeys = r.i64()
    if not 0 < nkeys <= 64:
        raise IOError_(f"binary parse: bad secret-key count {nkeys}")
    sk_rows = None
    for _ in range(nkeys):
        s, rows = r.dcrt()
        if len(s) == nprimes:
            sk_rows = rows
    r.expect(b"]SK|")
    if sk_rows is None:
        raise IOError_("binary parse: no full-chain secret key found")

    return HelibBinaryDump(m=m, p=p, r=rr, gens=gens, ords=ords,
                           primes=primes, pub_enc_parts=pub_parts,
                           pub_ptxt_space=pub_space, sk_rows=sk_rows,
                           stdev=stdev, sk_hwts=sk_hwts, ks_matrices=mats,
                           pub_noise=pub_noise)


# ---------------------------------------------------------------------------
# Writer: emit the same v1 tagged-binary wire format (HElib's
# src/binio.cpp:19-145 primitives; misc/legacy_tests/Test_Bin_IO.cpp object
# order), the migration path out.
#
# DoubleCRT rows are evaluations at the primitive m-th roots.  HElib's row
# ordering is NTL's zMStar order, which cannot be reproduced without NTL;
# exported files use this package's eval ordering (ascending root
# exponent), which is format-conformant and self-consistent -- the
# decryption-identity check passes on re-read because every consumer here
# (and HElib's own algebra) is per-eval-column.  The bytes are those of
# helib_tpu's exporter; each residue tensor crosses to the host once and is
# packed by numpy.
# ---------------------------------------------------------------------------

import math as _math

import numpy as _np

from .ops.modops import to_host


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def tag(self, t: bytes):
        self.parts.append(t)

    def i64(self, v: int):
        self.parts.append(struct.pack("<q", int(v)))

    def f64(self, v: float):
        self.parts.append(struct.pack("<d", float(v)))

    def xdouble(self, v: float):
        """mantissa * 2^exp split (reference write_raw_xdouble); noise
        magnitudes can exceed double range, hence the split."""
        if v <= 0.0:
            self.f64(0.0)
            self.i64(0)
            return
        e = 0
        m = float(v)
        while m >= 1.0:
            m /= 2.0
            e += 1
        while m < 0.5:
            m *= 2.0
            e -= 1
        self.f64(m)
        self.i64(e)

    def xdouble_log2(self, log2v: float):
        """xdouble from a log2-domain magnitude (this package's noise
        representation) -- avoids overflowing a double when log2v > 1024."""
        if log2v == float("-inf"):
            self.f64(0.0)
            self.i64(0)
            return
        e = int(_math.floor(log2v)) + 1
        self.f64(2.0 ** (log2v - e))
        self.i64(e)

    def iset(self, idxs):
        self.i64(len(idxs))
        for v in idxs:
            self.i64(v)

    def vec_long(self, vals, int_size: int = 8):
        self.parts.append(struct.pack("<ii", len(vals), int_size))
        dt = "<i8" if int_size == 8 else "<i4"
        self.parts.append(_np.asarray(vals, dtype=dt).tobytes())

    def i64_vec(self, vals):
        self.i64(len(vals))
        for v in vals:
            self.i64(v)

    def zz(self, v: int):
        nb = max(1, (int(v).bit_length() + 7) // 8)
        self.i64(nb)
        self.parts.append(int(v).to_bytes(nb, "little"))

    def dcrt(self, idxs, rows):
        self.iset(idxs)
        for row in rows:
            self.vec_long(row)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


def _write_base(w: _Writer, m, p, r, gens, ords):
    w.tag(b"|BS[")
    w.i64(p); w.i64(r); w.i64(m)
    w.i64_vec(gens)
    w.i64_vec(ords)
    w.tag(b"]BS|")


def _write_ctxt_block(w: _Writer, pspace, noise, pset, parts):
    """parts: [(handle3, idxs, rows)] — the reader's pub_enc_parts shape."""
    w.tag(b"|CX[")
    w.i64(pspace)
    if isinstance(noise, tuple) and noise[0] == "log2":
        w.xdouble_log2(noise[1])
    else:
        w.xdouble(noise)
    w.iset(pset)
    w.i64(len(parts))
    for handle, idxs, rows in parts:
        w.dcrt(idxs, rows)
        for h in handle:
            w.i64(h)
    w.tag(b"]CX|")


def _write_ks_matrix(w: _Writer, mat: HelibBinaryKSMatrix):
    w.tag(b"|KM[")
    for h in mat.handle:
        w.i64(h)
    w.i64(mat.to_key)
    w.i64(mat.ptxt_space)
    w.i64(len(mat.b_columns))
    for idxs, rows in mat.b_columns:
        w.dcrt(idxs, rows)
    w.zz(mat.prg_seed)
    w.tag(b"]KM|")


def write_dump_binary(dump: HelibBinaryDump, path: str):
    """Re-emit a parsed dump in the v1 wire format.  write(read(fixture))
    re-read equals the original dump field-for-field — the validation the
    shipped fixtures enable without building the reference."""
    w = _Writer()
    _write_base(w, dump.m, dump.p, dump.r, dump.gens, dump.ords)

    w.tag(b"|CN[")
    w.f64(dump.stdev)
    w.i64_vec([])                              # smallPrimes (none)
    w.i64_vec(list(range(len(dump.primes))))   # ctxtPrimes
    w.i64(len(dump.primes))
    for q in dump.primes:
        w.i64(q)
    w.i64(0)                                   # ndigits (trailer skipped)
    w.tag(b"]CN|")

    def _pk_block():
        w.tag(b"|PK[")
        _write_base(w, dump.m, dump.p, dump.r, dump.gens, dump.ords)
        _write_ctxt_block(w, dump.pub_ptxt_space, dump.pub_noise,
                          dump.pub_enc_parts[0][1], dump.pub_enc_parts)
        w.i64_vec(dump.sk_hwts)
        w.i64(len(dump.ks_matrices))
        for mat in dump.ks_matrices:
            _write_ks_matrix(w, mat)
        w.tag(b"]PK|")

    _pk_block()
    w.tag(b"|SK[")
    _pk_block()
    w.i64(1)
    w.dcrt(list(range(len(dump.primes))), dump.sk_rows)
    w.tag(b"]SK|")
    with open(path, "wb") as f:
        f.write(w.getvalue())


# -- export of this package's objects ---------------------------------------

def _primitive_cols(ctx):
    """Columns of our eval rows at primitive m-th roots, ascending
    exponent.  pow2 m: every eval point is primitive already."""
    if ctx.pal.pow2:
        return None
    m = ctx.m
    return _np.array([j for j in range(m) if _math.gcd(j, m) == 1])


def _export_rows(ctx, data, rows):
    """Eval-domain residue tensor [(R, N)] -> per-prime rows at the
    primitive roots (phi(m) wide), an int64 array [R, phi(m)]; one host
    transfer."""
    arr = to_host(data)
    cols = _primitive_cols(ctx)
    if cols is not None:
        arr = arr[..., cols]
    return arr.astype(_np.int64)


def _export_parts(ctx, ct):
    rows_idx = list(ctx.rows_of(ct.k, ct.special))
    parts = []
    for h, d in ct.parts:
        parts.append(((h.powS, h.powX, h.keyID), rows_idx,
                      _export_rows(ctx, d, rows_idx)))
    return parts


def export_helib_binary(path: str, ctx, sk=None, pk=None, ctxts=()):
    """Export Context (+PubKey/SecKey/Ctxts) in the v1 HElib binary wire
    format, the same bytes as helib_tpu's export of the same objects;
    read_binary_dump parses the result and the decryption identity
    c0 + c1*s = p*e holds on the exported rows (primitive-root columns of
    the eval representation -- see the note on ordering above)."""
    w = _Writer()
    pal = ctx.pal
    gens = list(pal.gens)
    ords = [(o if nat else -o) for o, nat in zip(pal.orders, pal.native)]
    _write_base(w, ctx.m, ctx.p, ctx.r, gens, ords)

    all_primes = [int(q) for q in ctx.all_q]
    w.tag(b"|CN[")
    w.f64(ctx.stdev)
    w.i64_vec([])
    w.i64_vec(list(range(ctx.L)))
    w.i64(len(all_primes))
    for q in all_primes:
        w.i64(q)
    w.i64(len(ctx.digits))
    w.tag(b"]CN|")

    def _pk_block(pk):
        w.tag(b"|PK[")
        _write_base(w, ctx.m, ctx.p, ctx.r, gens, ords)
        enc_rows = list(range(ctx.L))
        enc_parts = [((h.powS, h.powX, h.keyID), enc_rows,
                      _export_rows(ctx, d, enc_rows))
                     for h, d in pk.enc_key]
        _write_ctxt_block(w, ctx.ptxt_space, ("log2", pk.enc_noise),
                          enc_rows, enc_parts)
        w.i64_vec([0])
        mats = []
        for W in pk.matrices.values():
            full = list(range(ctx.L + ctx.S))
            cols = [(full, _export_rows(ctx, b, full)) for b in W.b]
            mats.append(HelibBinaryKSMatrix(
                (W.from_handle.powS, W.from_handle.powX,
                 W.from_handle.keyID),
                W.to_key, W.ptxt_space, cols, W.prg_seed or 0))
        w.i64(len(mats))
        for mat in mats:
            _write_ks_matrix(w, mat)
        w.tag(b"]PK|")

    if pk is not None:
        _pk_block(pk)
    if sk is not None:
        if pk is None:
            from .keys import PubKey
            _pk_block(sk.pubkey or PubKey(sk))
        w.tag(b"|SK[")
        _pk_block(pk if pk is not None else sk.pubkey)
        w.i64(len(sk.skeys))
        full = list(range(ctx.L + ctx.S))
        for k in sk.skeys:
            w.dcrt(full, _export_rows(ctx, k["full"], full))
        w.tag(b"]SK|")
    for ct in ctxts:
        _write_ctxt_block(w, ct.ptxt_space, ("log2", ct.noise),
                          list(ctx.rows_of(ct.k, ct.special)),
                          _export_parts(ctx, ct))
    with open(path, "wb") as f:
        f.write(w.getvalue())
