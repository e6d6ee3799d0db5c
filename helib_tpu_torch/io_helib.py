"""Readers for HElib's LEGACY text serialization format (helib_tpu.io_helib).

The reference ships endianness golden fixtures
(tests/test_resources/iotest_ascii{LE,BE}.txt, referenced from
tests/CMakeLists.txt:96-99) written by the legacy text writers
(misc/legacy_tests/Test_IO.cpp): context base "[m p r [gens] [ords]]",
context body (stdev, prime partitions, the modulus chain, digits), then
SecKey objects (PubKey part incl. pubEncrKey — an encryption of zero —
key-switching matrices, keySwitchMap, and the secret key itself as a
DoubleCRT over the full prime chain).

These readers are a cross-validation channel that needs no build of HElib
(NTL/GMP): they parse HElib's own serialized key material, whose decryption
identity c0 + c1*s = p*e (small) can then be checked with this package's
arithmetic (pointwise eval-domain products + balanced CRT reconstruction).

Note on eval ordering: HElib's DoubleCRT rows are evaluations at the
primitive m-th roots in zMStar order.  All checks here are pointwise or
per-eval-column, which is ordering-independent, so no NTL table
replication is needed.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from .exceptions import IOError_

# proper number tokens only: no bare 'e' / '+' / '.' fragments
_NUM_RE = re.compile(r"\[|\]|[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def tokenize(text: str):
    return _NUM_RE.findall(text)


def parse_all(text: str):
    """Parse the bracketed token stream into nested python lists; numbers
    become int (or float when they contain '.' or an exponent)."""
    toks = tokenize(text)
    pos = 0

    def parse_item():
        nonlocal pos
        if pos >= len(toks):
            raise IOError_("legacy parse: unexpected end of token stream")
        t = toks[pos]
        if t == "[":
            pos += 1
            out = []
            while True:
                if pos >= len(toks):
                    raise IOError_("legacy parse: unterminated '['")
                if toks[pos] == "]":
                    break
                out.append(parse_item())
            pos += 1
            return out
        if t == "]":
            raise IOError_("legacy parse: unmatched ']'")
        pos += 1
        try:
            return float(t) if ("." in t or "e" in t or "E" in t) else int(t)
        except ValueError as exc:
            raise IOError_(f"legacy parse: bad number token {t!r}") from exc

    items = []
    while pos < len(toks):
        items.append(parse_item())
    return items


def _iter_lists(node):
    if isinstance(node, list):
        yield node
        for x in node:
            yield from _iter_lists(x)


def _is_dcrt(node, nprimes: int, width: int):
    return (isinstance(node, list) and len(node) == 1 + nprimes
            and node[0] == list(range(nprimes))
            and all(isinstance(r, list) and len(r) == width
                    and all(isinstance(v, int) for v in r)
                    for r in node[1:]))


@dataclass
class HelibLegacyDump:
    m: int
    p: int
    r: int
    gens: list
    ords: list
    primes: list           # full modulus chain (ints)
    pub_enc_parts: list    # [(handle, prime_idx_list, rows)] of pubEncrKey
    pub_ptxt_space: int
    sk_rows: list          # secret key DoubleCRT rows over ALL primes


def read_legacy_dump(path: str) -> HelibLegacyDump:
    with open(path) as f:
        items = parse_all(f.read())
    base = items[0]                       # [m p r [gens] [ords]]
    m, p, r, gens, ords = base[0], base[1], base[2], base[3], base[4]
    body = items[1]
    # context body: [stdev [ctxt-prime idxs] nprimes prime... ndigits
    #                [digit sets]... [special idxs] flags...]
    flat = [x for x in body if isinstance(x, (int, float))]
    nprimes = None
    primes = []
    for i, x in enumerate(flat):
        if isinstance(x, int) and x > 1 and nprimes is None and i >= 1:
            nprimes = x
            primes = [v for v in flat[i + 1:i + 1 + nprimes]]
            break
    if not nprimes or len(primes) != nprimes:
        raise IOError_(f"legacy parse: bad prime chain "
                       f"(nprimes={nprimes}, got {len(primes)})")
    phi = len([k for k in range(1, m) if __import__("math").gcd(k, m) == 1])

    # pubEncrKey: [ptxtSpace noiseVar [primeSet] nparts part...] with
    # part = [DoubleCRT handle]
    pub = None
    for L in _iter_lists(items):
        if (len(L) >= 5 and isinstance(L[0], int) and L[0] > 1
                and isinstance(L[1], float) and isinstance(L[2], list)
                and L[3] == len(L) - 4
                and all(isinstance(x, list) and len(x) == 2 for x in L[4:])):
            pub = L
            break
    if pub is None:
        raise IOError_("legacy parse: pubEncrKey not found")
    pset = pub[2]
    parts = []
    for part in pub[4:]:
        dcrt, handle = part
        if dcrt[0] != pset:
            raise IOError_("legacy parse: pubEncrKey part prime set mismatch")
        rows = dcrt[1:]
        if not all(len(rr) == phi for rr in rows):
            raise IOError_("legacy parse: pubEncrKey row width != phi(m)")
        parts.append((tuple(handle), list(pset), rows))

    # secret key: the LAST full-chain DoubleCRT in the file
    sk = None
    for L in _iter_lists(items):
        if _is_dcrt(L, nprimes, phi):
            sk = L
    if sk is None:
        raise IOError_("legacy parse: secret key DoubleCRT not found")
    return HelibLegacyDump(m=m, p=p, r=r, gens=gens, ords=ords,
                           primes=primes, pub_enc_parts=parts,
                           pub_ptxt_space=pub[0], sk_rows=sk[1:])
