"""Port vs helib_tpu, encrypted, on the host CPU: the bit-sliced binary
circuits (add, multiply, compare, add_many, negate, the compression adders,
the bitwise ops, shifts and rotate, concat and split, binary_cond and
binary_mask), the table lookup and write-in, intraslot unpack/repack and
the utils products, run once in each package at m=31, p=2, bits=500, c=3
(6 slots of GF(2^5)) on the same seeded keys and encryptions.  Every output
ciphertext must be equal residue for residue and decrypt to the numpy
oracle."""

import types

import numpy as np
import pytest
import torch

from helib_tpu import utils as jutils
from helib_tpu.algos import binary as jbin, intraslot as jintra
from helib_tpu.algos import tablelookup as jtl
from helib_tpu.context import Context as JContext
from helib_tpu.ea import EncryptedArray as JEA
from helib_tpu.keys import SecKey as JSecKey, PubKey as JPubKey
from helib_tpu.ops import ntt as jntt

from helib_tpu_torch import utils as tutils
from helib_tpu_torch.algos import binary as tbin, intraslot as tintra
from helib_tpu_torch.algos import tablelookup as ttl
from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.ea import EncryptedArray as TEA
from helib_tpu_torch.keys import SecKey as TSecKey, PubKey as TPubKey
from helib_tpu_torch.ops.modops import to_host

torch.set_num_threads(1)

JAX = types.SimpleNamespace(Context=JContext, EA=JEA, SecKey=JSecKey,
                            PubKey=JPubKey, bin=jbin, tl=jtl, intra=jintra,
                            utils=jutils, kw={})
PORT = types.SimpleNamespace(Context=TContext, EA=TEA, SecKey=TSecKey,
                             PubKey=TPubKey, bin=tbin, tl=ttl, intra=tintra,
                             utils=tutils, kw={"device": "cpu"})

M31 = dict(m=31, p=2, r=1, bits=500, c=3)
W = 3                       # the width of the numbers added and compared


def _circuits(pkg):
    """{name: list of ciphertexts} of every circuit in one package, and the
    cleartext inputs."""
    ctx = pkg.Context(**M31, **pkg.kw)
    sk = pkg.SecKey(ctx, seed=31)
    pk = pkg.PubKey(sk)
    ea = pkg.EA(ctx)
    B = pkg.bin
    rng = np.random.default_rng(37)
    n = ea.nslots
    a, b = rng.integers(0, 1 << W, n), rng.integers(0, 1 << W, n)
    b[0] = a[0]
    c = rng.integers(0, 4, n)
    cond = rng.integers(0, 2, n)
    ones = [rng.integers(0, 2, n) for _ in range(9)]
    ca, cb = (B.encrypt_number(ea, pk, rng, v, W) for v in (a, b))
    cc = B.encrypt_number(ea, pk, rng, c, 2)
    ccond = ea.encrypt(list(cond), pk, rng)
    cones = [ea.encrypt(list(v), pk, rng) for v in ones]
    out = {"encrypt": ca + cb + cc + [ccond],
           "add": B.add_two_numbers(ea, ca, cb, sk),
           "add_short": B.add_two_numbers(ea, ca, cc, sk, W),
           "mult": B.mult_two_numbers(ea, ca[:2], cb[:2], sk),
           "compare": list(B.compare_two_numbers(ea, ca, cb, sk)),
           "add_many": B.add_many_numbers(ea, [ca[:2], cb[:2], cc], sk),
           "negate": B.negate_number(ea, ca, sk, W),
           "xor": B.bitwise_xor(ea, ca, cc),
           "and": B.bitwise_and(ea, ca, cb, sk),
           "or": B.bitwise_or(ea, ca, cb, sk),
           "not": B.bitwise_not(ea, ca),
           "left_shift": B.left_shift(ea, ca, 1, W),
           "right_shift": B.right_bitwise_shift(ea, ca, 1),
           "rotate": B.bitwise_rotate(ea, ca, 2),
           "rotate_back": B.bitwise_rotate(ea, ca, -1),
           "concat": B.concat_binary_nums(ca, cc),
           "split_lo": B.split_binary_nums(ca, 2)[0],
           "split_hi": B.split_binary_nums(ca, 2)[1],
           "cond": B.binary_cond(ea, ccond, ca, cb, sk),
           "mask": B.binary_mask(ea, ccond, ca, sk)}
    for k in (2, 5, 9):
        bits = cones[:k]
        bits = bits[:1] + [None] + bits[1:]
        out[f"fifteen{k}"] = B.fifteen_or_less_4_four(ea, bits, sk)[0]
    # the table lookup on a 2-bit index, and a write-in at that index
    table = pkg.tl.build_lookup_table(lambda i: 3 * i + 1, 2, 2)
    out["lookup"] = [pkg.tl.table_lookup(ea, cc, table, sk)]
    entries = [ea.encrypt([int(v)] * n, pk, rng) for v in (1, 0, 1, 1)]
    out["write_in"] = pkg.tl.table_write_in(ea, cc, entries, ccond, sk)
    # intraslot: full GF(2^5) slots unpacked into d bit ciphertexts, repacked
    full = [rng.integers(0, 2, ea.d) for _ in range(n)]
    cfull = ea.encrypt(full, pk, rng)
    unpacked = pkg.intra.unpack(ea, cfull, sk)
    out["unpack"] = unpacked
    out["repack"] = [pkg.intra.repack(ea, unpacked)]
    # the utils products over three bit ciphertexts
    U = pkg.utils
    three = cones[:3]
    out["total_product"] = [U.total_product(three, sk)]
    out["inner_product"] = [U.inner_product(three, cones[3:6], sk)]
    out["incremental_product"] = U.incremental_product(
        [x.copy() for x in three], sk)
    deeper = three[1].multiply(three[1], sk)
    out["multiply_by2"] = [U.multiply_by2(three[0], deeper, three[2], sk)]
    reg = U.SumRegister()
    for x in cones[:5]:
        reg.add(x)
    out["sum_register"] = [reg.result()]
    out["zero_one"] = [U.zero_like(ca[0]), U.one_like(ea, ca[0])]
    clear = dict(a=a, b=b, c=c, cond=cond, ones=ones, full=full, table=table)
    return out, (ctx, sk, ea, clear)


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jntt, "USE_PALLAS", False)
        jout, _ = _circuits(JAX)
    tout, held = _circuits(PORT)
    return jout, tout, held


def _same(j, t):
    """Equal residues, handles and noise metadata."""
    assert (t.k, t.special, t.ptxt_space, t.intFactor) == (
        j.k, j.special, j.ptxt_space, j.intFactor)
    assert abs(t.noise - j.noise) <= 1e-9
    assert [(h.powS, h.powX, h.keyID) for h, _ in t.parts] == [
        (h.powS, h.powX, h.keyID) for h, _ in j.parts]
    for (_, x), (_, y) in zip(t.parts, j.parts):
        np.testing.assert_array_equal(to_host(x), np.asarray(y))


def _oracles(ea, clear) -> dict:
    """name -> the integers each slot of the output number must hold (a
    list of slot vectors for outputs that are lists of separate bits)."""
    a, b, c, cond, ones = (clear[k] for k in ("a", "b", "c", "cond",
                                              "ones"))
    mask = (1 << W) - 1
    sel = [c == i for i in range(4)]
    table = clear["table"]
    bits = lambda v, w: [(v >> i) & 1 for i in range(w)]  # noqa: E731
    prods = [ones[0] * ones[1] * ones[2]]
    return {
        "encrypt": bits(a, W) + bits(b, W) + bits(c, 2) + [cond],
        "add": a + b, "add_short": (a + c) & mask,
        "mult": (a & 3) * (b & 3), "compare": [(a > b) * 1, (a == b) * 1],
        "add_many": (a & 3) + (b & 3) + c, "negate": -a & mask,
        "xor": a ^ c, "and": a & b, "or": a | b, "not": ~a & mask,
        "left_shift": (a << 1) & mask, "right_shift": a >> 1,
        "rotate": ((a << 2) | (a >> (W - 2))) & mask,
        "rotate_back": ((a >> 1) | (a << (W - 1))) & mask,
        "concat": a + (c << W), "split_lo": a & 3, "split_hi": a >> 2,
        "cond": np.where(cond == 1, a, b), "mask": a * cond,
        "fifteen2": sum(ones[:2]), "fifteen5": sum(ones[:5]),
        "fifteen9": sum(ones[:9]),
        "lookup": [sum(np.int64(table[i]) * sel[i] for i in range(4))],
        "write_in": [(np.int64(v) + cond * sel[i]) % 2
                     for i, v in enumerate((1, 0, 1, 1))],
        "unpack": [np.array([s[j] for s in clear["full"]])
                   for j in range(ea.d)],
        "total_product": prods,
        "inner_product": [sum(ones[i] * ones[3 + i] for i in range(3)) % 2],
        "incremental_product": [ones[0], ones[0] * ones[1], prods[0]],
        "multiply_by2": prods, "sum_register": [sum(ones[:5]) % 2],
        "zero_one": [np.zeros_like(a), np.ones_like(a)]}


# outputs that are one number (decrypt_number) rather than separate bits
NUMBERS = {"add", "add_short", "mult", "add_many", "negate", "xor", "and",
           "or", "not", "left_shift", "right_shift", "rotate",
           "rotate_back", "concat", "split_lo", "split_hi", "cond", "mask",
           "fifteen2", "fifteen5", "fifteen9"}
NAMES = sorted(NUMBERS | {"encrypt", "compare", "lookup", "write_in",
                          "unpack", "repack", "total_product",
                          "inner_product", "incremental_product",
                          "multiply_by2", "sum_register", "zero_one"})


@pytest.mark.parametrize("name", NAMES)
def test_circuit_residues_equal_reference(runs, name):
    jout, tout, _ = runs
    assert len(jout[name]) == len(tout[name]) > 0
    for j, t in zip(jout[name], tout[name]):
        _same(j, t)


@pytest.mark.parametrize("name", NAMES)
def test_circuit_decrypts_to_oracle(runs, name):
    _, tout, (ctx, sk, ea, clear) = runs
    if name == "repack":
        got = sk.decrypt_bgv(tout[name][0])
        np.testing.assert_array_equal(got, ea.encode(clear["full"]))
        return
    want = _oracles(ea, clear)[name]
    if name in NUMBERS:
        np.testing.assert_array_equal(
            tbin.decrypt_number(ea, sk, tout[name]), want)
        return
    assert len(tout[name]) == len(want)
    for ct, w in zip(tout[name], want):
        np.testing.assert_array_equal(ea.decrypt_ints(ct, sk), w)


def test_circuits_stay_correct_and_use_one_matrix(runs):
    """Every output is still decryptable by its noise estimate, and the
    whole run minted the relinearization matrix and the Frobenius ones
    unpack uses, no rotation."""
    _, tout, (ctx, sk, ea, _) = runs
    for name, cts in tout.items():
        for ct in cts:
            assert ct.is_correct(), (name, ct.capacity())
    assert {h[1] for h in sk.matrices} <= {
        pow(2, j, ctx.m) for j in range(ea.d)}
