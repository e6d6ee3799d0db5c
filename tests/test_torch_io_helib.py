"""Port vs helib_tpu: HElib's legacy dumps.  At m=31 the port's
export_helib_binary of a context, SecKey, PubKey (with a relinearization
matrix) and a ciphertext is byte-identical to helib_tpu's export of the
same objects (keys from the same seed, the ciphertext carried by
helib_tpu_torch.convert), each package's read_binary_dump parses the
other's file, HElib's decryption identity c0 + c1*s = p*e holds on the
exported rows, and read_legacy_dump agrees on a text dump."""

import math
import dataclasses

import numpy as np
import pytest
import torch

from helib_tpu.context import Context as JContext
from helib_tpu.keys import SecKey as JSecKey, PubKey as JPubKey
from helib_tpu.keys import SKHandle as JSKHandle
from helib_tpu.ea import EncryptedArray as JEA
from helib_tpu import io_helib as jio, io_helib_bin as jbin

from helib_tpu_torch import convert, io_helib, io_helib_bin
from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.keys import SecKey as TSecKey, PubKey as TPubKey
from helib_tpu_torch.keys import SKHandle
from helib_tpu_torch.exceptions import IOError_

torch.set_num_threads(1)

PARAMS = dict(m=31, p=2, r=1, bits=120, c=2)   # test_helib_interop.py's


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    d = tmp_path_factory.mktemp("io_helib")
    jc, tc = JContext(**PARAMS), TContext(**PARAMS, device="cpu")
    jsk, tsk = JSecKey(jc, seed=17), TSecKey(tc, seed=17)
    jpk, tpk = JPubKey(jsk), TPubKey(tsk)
    jsk.gen_ks_matrix(JSKHandle(2, 1, 0))
    tsk.gen_ks_matrix(SKHandle(2, 1, 0))
    rng = np.random.default_rng(19)
    jct = JEA(jc).encrypt(list(rng.integers(0, 2, 6)), jpk, rng)
    tct = convert.ctxt_from_arrays(
        tc, tpk, [((h.powS, h.powX, h.keyID), np.asarray(x))
                  for h, x in jct.parts],
        jct.k, jct.special, jct.ptxt_space, jct.noise, jct.intFactor)
    paths = {"port": str(d / "port.bin"), "jax": str(d / "jax.bin")}
    io_helib_bin.export_helib_binary(paths["port"], tc, sk=tsk, pk=tpk,
                                     ctxts=[tct])
    jbin.export_helib_binary(paths["jax"], jc, sk=jsk, pk=jpk, ctxts=[jct])
    return tc, paths, d


def _fields(dump):
    out = {f.name: getattr(dump, f.name) for f in dataclasses.fields(dump)}
    if "ks_matrices" in out:
        out["ks_matrices"] = [dataclasses.asdict(k)
                              for k in dump.ks_matrices]
    return out


def test_export_bytes_equal_helib_tpu(exports):
    tc, paths, _ = exports
    with open(paths["port"], "rb") as f, open(paths["jax"], "rb") as g:
        port, ref = f.read(), g.read()
    assert port == ref
    assert port.count(b"|KM[") == 2      # the PubKey's, and the SecKey's copy


def test_each_reader_parses_the_others_file(exports):
    tc, paths, _ = exports
    mine = io_helib_bin.read_binary_dump(paths["jax"])
    theirs = jbin.read_binary_dump(paths["port"])
    assert _fields(mine) == _fields(theirs)
    assert (mine.m, mine.p, mine.r) == (31, 2, 1)
    assert mine.primes == [int(q) for q in tc.all_q]
    assert [k.handle for k in mine.ks_matrices] == [(2, 1, 0)]


def test_decryption_identity_on_exported_rows(exports):
    """c0 + c1*s per prime at the exported primitive-root columns is p*e:
    the same small integer vector on every prime (interpolated back to
    coefficients), even and noise-sized."""
    tc, paths, _ = exports
    d = io_helib_bin.read_binary_dump(paths["port"])
    pset = d.pub_enc_parts[0][1]
    prim = [j for j in range(tc.m) if math.gcd(j, tc.m) == 1]
    assert len(d.pub_enc_parts[0][2][0]) == tc.phi_m == len(prim)
    from helib_tpu_torch.nt.numbth import root_of_unity
    ref = None
    for ri, q in enumerate([d.primes[i] for i in pset][:3]):
        c0, c1 = d.pub_enc_parts[0][2][ri], d.pub_enc_parts[1][2][ri]
        v = [(a + b * s) % q for a, b, s in zip(c0, c1, d.sk_rows[ri])]
        w = root_of_unity(tc.m, q)
        # solve V g = v, V[i][k] = w^(prim_i k), by Gauss-Jordan mod q
        n = len(v)
        M = [[pow(w, prim[i] * k, q) for k in range(n)] + [v[i]]
             for i in range(n)]
        for col in range(n):
            piv = next(i for i in range(col, n) if M[i][col] % q)
            M[col], M[piv] = M[piv], M[col]
            inv = pow(M[col][col], -1, q)
            M[col] = [x * inv % q for x in M[col]]
            for i in range(n):
                if i != col and M[i][col]:
                    f = M[i][col]
                    M[i] = [(a - f * b) % q for a, b in zip(M[i], M[col])]
        g = [M[i][n] for i in range(n)]
        g = [x - q if x > q // 2 else x for x in g]
        ref = g if ref is None else ref
        assert g == ref
    assert all(x % 2 == 0 for x in ref) and max(map(abs, ref)) < 2 ** 20


def _text_dump(d) -> str:
    """A legacy text dump of a binary dump's fields, in the layout
    read_legacy_dump reads (the context base, the context body, the
    pubEncrKey ciphertext, the secret key DoubleCRT)."""
    lst = lambda xs: "[" + " ".join(str(x) for x in xs) + "]"
    n = len(d.primes)
    pset = d.pub_enc_parts[0][1]
    parts = " ".join(
        "[[" + lst(idx) + " " + " ".join(lst(r) for r in rows) + "] "
        + lst(h) + "]" for h, idx, rows in d.pub_enc_parts)
    return (f"[{d.m} {d.p} {d.r} {lst(d.gens)} {lst(d.ords)}]\n"
            f"[{d.stdev!r} {lst(range(len(pset)))} {n} {lst(d.primes)[1:-1]}"
            f" 1 {lst(pset)}]\n"
            f"[{d.pub_ptxt_space} 1.5 {lst(pset)} {len(d.pub_enc_parts)} "
            f"{parts}]\n"
            f"[{lst(range(n))} {' '.join(lst(r) for r in d.sk_rows)}]\n")


def test_legacy_text_readers_agree(exports):
    tc, paths, tmp = exports
    d = io_helib_bin.read_binary_dump(paths["port"])
    path = tmp / "dump.txt"
    path.write_text(_text_dump(d))
    mine, theirs = io_helib.read_legacy_dump(str(path)), \
        jio.read_legacy_dump(str(path))
    assert _fields(mine) == _fields(theirs)
    assert (mine.m, mine.primes, mine.sk_rows) == (d.m, d.primes, d.sk_rows)
    assert [(tuple(h), rows) for h, _, rows in mine.pub_enc_parts] == [
        (tuple(h), rows) for h, _, rows in d.pub_enc_parts]
    bad = tmp / "bad.txt"
    bad.write_text("[31 2 1 [3] [6]] [3.2 [0] 1 7 ]")
    with pytest.raises(IOError_):
        io_helib.read_legacy_dump(str(bad))
