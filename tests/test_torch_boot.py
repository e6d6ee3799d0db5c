"""Port vs helib_tpu, encrypted, on the host CPU: BGV bootstrapping.

At prime m=31 (bits=800, SecKey(seed=61, hwt=16), RecryptData(hwt=16), as
tests/test_bootstrap.py builds it; the dense LinearMapR maps) both packages
build the recryption data from the same seeds and run one thin_recrypt.
The helib_tpu run records the inputs and outputs of the functions it
calls (the two maps, the hoisted automorphism, the raw mod switch,
extract_digits_thin, extract_digits, divide_by_p, mult_by_p,
reduce_ptxt_space), and the port's function is run on each recorded input
and held to the recorded output bit for bit.  The port's own recrypt must
equal helib_tpu's residue for residue, decrypt to its input, gain capacity
and keep computing; the PubKey-only recrypt must mint nothing and equal it.
extract_bits and the Chen-Han branch run on the coefficient-to-slot
output reduced to 2^3 and 2^4; MatMulFull and BlockMatMulFull on fresh
ciphertexts after the recrypt.

At m=255, mvec=(3, 5, 17) (the factor-tree maps) the thin and fat EvalMap
round trips, MatMul1D with and without BSGS and the recorded BlockMatMul1D
and trace_map are held the same way.  The full recrypts at m=255 and the
composite m=45 recrypt are `slow`."""

import types

import numpy as np
import pytest
import torch

from helib_tpu import recryption as jrc, evalmap as jem, ctxt as jctxt
from helib_tpu.algos import extract as jex, hoisting as jho, matmul as jmm
from helib_tpu.context import Context as JContext
from helib_tpu.ea import EncryptedArray as JEA
from helib_tpu.keys import SecKey as JSecKey, PubKey as JPubKey
from helib_tpu.ops import ntt as jntt

from helib_tpu_torch import convert, recryption as trc, evalmap as tem
from helib_tpu_torch.algos import (extract as tex, hoisting as tho,
                                   matmul as tmm)
from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.ea import EncryptedArray as TEA
from helib_tpu_torch.keys import SecKey as TSecKey, PubKey as TPubKey
from helib_tpu_torch.ops.modops import to_host

torch.set_num_threads(1)

JAX = types.SimpleNamespace(Context=JContext, EA=JEA, SecKey=JSecKey,
                            PubKey=JPubKey, rc=jrc, em=jem, mm=jmm, kw={})
PORT = types.SimpleNamespace(Context=TContext, EA=TEA, SecKey=TSecKey,
                             PubKey=TPubKey, rc=trc, em=tem, mm=tmm,
                             kw={"device": "cpu"})

M31 = dict(m=31, p=2, r=1, bits=800, c=3)
M255 = dict(m=255, p=2, r=1, bits=600, c=3, mvec=(3, 5, 17))


def _same(j, t):
    """Equal residues, handles and noise metadata."""
    assert (t.k, t.special, t.ptxt_space, t.intFactor) == (
        j.k, j.special, j.ptxt_space, j.intFactor)
    assert abs(t.noise - j.noise) <= 1e-9
    assert [(h.powS, h.powX, h.keyID) for h, _ in t.parts] == [
        (h.powS, h.powX, h.keyID) for h, _ in j.parts]
    for (_, a), (_, b) in zip(t.parts, j.parts):
        np.testing.assert_array_equal(to_host(a), np.asarray(b))


def _to_port(ct, pk):
    """A helib_tpu Ctxt as the port's, on the port key's context."""
    return convert.ctxt_from_arrays(pk.ctx, pk, **convert.ctxt_arrays(ct))


def _copy(out):
    """A ciphertext (or a list of them) as it is now: callers go on to
    mutate what these functions return."""
    if isinstance(out, list):
        return [_copy(x) for x in out]
    return out.copy() if hasattr(out, "parts") else out


def _record(mp, rec: dict):
    """Wraps helib_tpu's bootstrapping functions so the first call of each
    (per map instance) is kept in `rec` as (input, arguments, output)."""
    def method(cls, name):
        orig = getattr(cls, name)

        def wrapped(self, *a, **kw):
            before = self.copy()
            out = orig(self, *a, **kw)
            rec.setdefault(name, (before, a, self.copy()))
            return out
        mp.setattr(cls, name, wrapped)

    for name in ("divide_by_p", "mult_by_p", "reduce_ptxt_space",
                 "trace_map"):
        method(jctxt.Ctxt, name)

    def applier(cls):
        orig = cls.apply

        def wrapped(self, ctxt, key, *a, **kw):
            out = orig(self, ctxt, key, *a, **kw)
            rec.setdefault(("apply", id(self)), (ctxt.copy(), a, _copy(out)))
            return out
        mp.setattr(cls, "apply", wrapped)

    for cls in (jrc.LinearMapR, jmm.MatMul1D, jmm.BlockMatMul1D):
        applier(cls)

    def function(mod, name):
        orig = getattr(mod, name)

        def wrapped(ctxt, *a):
            out = orig(ctxt.copy(), *a)
            rec.setdefault(name, (ctxt.copy(), a, _copy(out)))
            return out
        mp.setattr(mod, name, wrapped)

    for name in ("raw_mod_switch", "extract_digits_thin", "extract_digits"):
        function(jrc, name)

    init, automorph = jho.AutomorphPrecon.__init__, \
        jho.AutomorphPrecon.automorph

    def rec_init(self, ctxt, key):
        init(self, ctxt, key)
        self.recorded_input = ctxt.copy()

    def rec_automorph(self, kexp):
        out = automorph(self, kexp)
        rec.setdefault("automorph", (self.recorded_input, (kexp,),
                                     out.copy()))
        return out
    mp.setattr(jho.AutomorphPrecon, "__init__", rec_init)
    mp.setattr(jho.AutomorphPrecon, "automorph", rec_automorph)


def _boot31(pkg):
    ctx = pkg.Context(**M31, **pkg.kw)
    sk = pkg.SecKey(ctx, seed=61, hwt=16)
    pk = pkg.PubKey(sk)
    ea = pkg.EA(ctx)
    rc = pkg.rc.RecryptData(ctx, sk, ea, hwt=16)
    state = convert.recrypt_state(rc, sk)
    rng = np.random.default_rng(67)
    slots = rng.integers(0, ctx.ptxt_space, ea.nslots)
    low = ea.encrypt(list(slots), pk, rng)
    low.bring_to_k(3)
    out = pkg.rc.thin_recrypt(low, rc, sk)
    return types.SimpleNamespace(ctx=ctx, sk=sk, pk=pk, ea=ea, rc=rc,
                                 state=state, slots=slots, low=low, out=out)


def _full_matmuls(pkg, t):
    """MatMulFull and BlockMatMulFull over the six slots of m=31, on fresh
    ciphertexts (the rotation matrices minted from sk.rng in the same order
    in both packages)."""
    ea, pk = t.ea, t.pk
    rng = np.random.default_rng(71)
    n, d, pr = ea.nslots, ea.d, ea.pr
    t.M = rng.integers(0, pr, (n, n))
    t.blocks = rng.integers(0, pr, (n, n, d, d))
    t.s = rng.integers(0, pr, n)
    t.w = [rng.integers(0, pr, d) for _ in range(n)]
    t.full = pkg.mm.MatMulFull(ea, lambda i, j: int(t.M[i, j])).apply(
        ea.encrypt(list(t.s), pk, rng), t.sk)
    t.block_full = pkg.mm.BlockMatMulFull(
        ea, lambda i, j: t.blocks[i, j]).apply(ea.encrypt(t.w, pk, rng), t.sk)


def _small_space(ct, space):
    out = ct.copy()
    out.reduce_ptxt_space(space)
    return out


@pytest.fixture(scope="module")
def boot31():
    """The m=31 thin recrypt in both packages (helib_tpu's recorded), and
    helib_tpu's extract_bits and Chen-Han extraction on its recorded
    coefficient-to-slot output reduced to 2^3 and 2^4 (mult_by_p, which the
    recrypt does not call at r=1, on that output too)."""
    rec = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jntt, "USE_PALLAS", False)
        _record(mp, rec)
        j = _boot31(JAX)
        c2s = rec["extract_digits_thin"][0]
        _small_space(c2s, 8).mult_by_p(2)
        j.bits = _small_space(c2s, 8).extract_bits(j.sk)
        j.chen_han = jex.extend_extract_digits(_small_space(c2s, 16), j.sk,
                                               2, 2)
        _full_matmuls(JAX, j)
    t = _boot31(PORT)
    _full_matmuls(PORT, t)
    return j, t, rec


@pytest.mark.parametrize("field", ["e", "ePrime", "big_space", "recrypt_key",
                                   "skeys", "ekey"])
def test_recrypt_data_state_equals_reference(boot31, field):
    """RecryptData draws the recryption key and ekey from sk.rng in
    helib_tpu's order: the carried state is equal."""
    j, t, _ = boot31
    a, b = j.state[field], t.state[field]
    if field == "skeys":
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["coeffs"], y["coeffs"])
            np.testing.assert_array_equal(x["full"], y["full"])
            assert x["bound"] == y["bound"]
        assert np.count_nonzero(b[t.rc.recrypt_key]["coeffs"]) == 16
    elif field == "ekey":
        for (h1, x), (h2, y) in zip(a["parts"], b["parts"]):
            assert h1 == h2
            np.testing.assert_array_equal(x, y)
        assert {k: v for k, v in a.items() if k != "parts"} == \
            {k: v for k, v in b.items() if k != "parts"}
        assert b["ptxt_space"] == t.rc.big_space
    else:
        assert a == b
    assert t.ctx.boot_ptxt_space == t.rc.big_space == 2**(t.rc.e - t.rc.ePrime
                                                          + 1)


def test_recrypt_matrices_equal_reference(boot31):
    """The matrices the cold recrypt minted: the same keys and residues, at
    the big plaintext space."""
    j, t, _ = boot31
    assert t.sk.matrices.keys() == j.sk.matrices.keys()
    for key, W in t.sk.matrices.items():
        V = j.sk.matrices[key]
        assert W.ptxt_space == V.ptxt_space == t.rc.big_space
        for x, y in zip(W.b + W.a, V.b + V.a):
            np.testing.assert_array_equal(to_host(x), np.asarray(y))


@pytest.mark.parametrize("name", ["slot_to_coeff", "coeff_to_slot"])
def test_linear_map_equals_reference(boot31, name):
    """LinearMapR at prime m: the same terms, and the port's apply on
    helib_tpu's recorded input gives its recorded output."""
    j, t, rec = boot31
    jm, tm = getattr(j.rc, name), getattr(t.rc, name)
    assert [(k, c.coeffs.tolist()) for k, c in tm.terms] == \
        [(k, np.asarray(c.coeffs).tolist()) for k, c in jm.terms]
    assert len(tm.terms) > 2      # the hoisted branch
    ct, _, out = rec[("apply", id(jm))]
    _same(out, tm.apply(_to_port(ct, t.pk), t.pk))


def test_hoisted_automorph_equals_reference(boot31):
    j, t, rec = boot31
    ct, (kexp,), out = rec["automorph"]
    _same(out, tho.AutomorphPrecon(_to_port(ct, t.pk), t.pk).automorph(kexp))


def test_raw_mod_switch_equals_reference(boot31):
    j, t, rec = boot31
    ct, args, out = rec["raw_mod_switch"]
    got = trc.raw_mod_switch(_to_port(ct, t.pk), *args)
    for a, b in zip(got, out):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["divide_by_p", "mult_by_p",
                                  "reduce_ptxt_space"])
def test_ctxt_op_equals_reference(boot31, name):
    j, t, rec = boot31
    ct, args, out = rec[name]
    got = _to_port(ct, t.pk)
    getattr(got, name)(*args)
    _same(out, got)


def test_extract_digits_thin_equals_reference(boot31):
    j, t, rec = boot31
    ct, args, out = rec["extract_digits_thin"]
    _same(out, trc.extract_digits_thin(_to_port(ct, t.pk), *args[:3], t.pk))
    ct, args, out = rec["extract_digits"]
    got = tex.extract_digits(_to_port(ct, t.pk), t.pk, *args[1:])
    assert len(got) == len(out) == args[1]
    for a, b in zip(out, got):
        _same(a, b)


def _digit_oracle(ea, sk, ct, digits):
    """Base-2 digits of the slot integers of ct (mod its space); `ea`
    decodes mod a multiple of that space."""
    rem = ea.decrypt_ints(ct, sk) % ct.ptxt_space
    for dj in digits:
        assert dj.is_correct(), dj.capacity()
        np.testing.assert_array_equal(ea.decrypt_ints(dj, sk) % 2, rem % 2)
        rem //= 2


@pytest.mark.parametrize("which", ["extract_digits", "extract_bits"])
def test_extract_bits_equals_reference(boot31, which):
    """Ctxt.extract_bits and extract_digits(r=3) on a space-2^3 ciphertext:
    helib_tpu's extract_bits, bit for bit, and the bits of the slots."""
    j, t, rec = boot31
    ct = _to_port(_small_space(rec["extract_digits_thin"][0], 8), t.pk)
    got = (ct.extract_bits(t.pk) if which == "extract_bits"
           else tex.extract_digits(ct, t.pk, 3))
    assert len(got) == len(j.bits) == 3
    for a, b in zip(j.bits, got):
        _same(a, b)
    _digit_oracle(t.rc.ea_big, t.sk, ct, got)


def test_chen_han_equals_reference(boot31):
    """extend_extract_digits at (p, r, e) = (2, 2, 2)."""
    j, t, rec = boot31
    ct = _to_port(_small_space(rec["extract_digits_thin"][0], 16), t.pk)
    got = tex.extend_extract_digits(ct, t.pk, 2, 2)
    assert len(got) == len(j.chen_han) == 2
    for a, b in zip(j.chen_han, got):
        _same(a, b)
    _digit_oracle(t.rc.ea_big, t.sk, ct, got)


@pytest.mark.parametrize("which", ["full", "block_full"])
def test_full_matmul_equals_reference(boot31, which):
    """MatMulFull (M @ slots) and BlockMatMulFull (d x d blocks over the
    slot ring) over all slots: helib_tpu's residues and the products."""
    j, t, _ = boot31
    _same(getattr(j, which), getattr(t, which))
    pr, n = t.ea.pr, t.ea.nslots
    if which == "full":
        np.testing.assert_array_equal(t.ea.decrypt_ints(t.full, t.sk),
                                      (t.M @ t.s) % pr)
        return
    got = t.ea.decrypt(t.block_full, t.sk)
    for s in range(n):
        want = sum(t.blocks[s, i] @ t.w[i] for i in range(n)) % pr
        np.testing.assert_array_equal(np.asarray(got[s]) % pr, want)


def test_thin_recrypt_equals_reference(boot31):
    j, t, _ = boot31
    _same(j.out, t.out)


def test_thin_recrypt_decrypts_and_gains_capacity(boot31):
    j, t, _ = boot31
    assert t.out.is_correct(), t.out.capacity()
    np.testing.assert_array_equal(t.ea.decrypt_ints(t.out, t.sk), t.slots)
    assert t.out.capacity() > t.low.capacity() + 30
    sq = t.out.multiply(t.out, t.sk)
    np.testing.assert_array_equal(t.ea.decrypt_ints(sq, t.sk),
                                  (t.slots * t.slots) % t.ctx.ptxt_space)


def test_thin_recrypt_pubkey_only(boot31):
    """With the PubKey alone after the cold run: nothing minted, the same
    residues; a carried key state (convert.load_recrypt_state) leaves it
    so."""
    j, t, _ = boot31
    n = len(t.sk.matrices)
    _same(j.out, trc.thin_recrypt(t.low, t.rc, t.pk))
    convert.load_recrypt_state(t.rc, t.sk, convert.recrypt_state(j.rc, j.sk))
    _same(j.out, trc.thin_recrypt(t.low, t.rc, t.pk))
    assert len(t.sk.matrices) == n


# ---------------------------------------------------------------------------
# m=255: the factor-tree maps
# ---------------------------------------------------------------------------

def _maps255(pkg):
    ctx = pkg.Context(**M255, **pkg.kw)
    sk = pkg.SecKey(ctx, seed=111)
    pk = pkg.PubKey(sk)
    ea = pkg.EA(ctx)
    rng = np.random.default_rng(113)
    out = types.SimpleNamespace(ctx=ctx, sk=sk, ea=ea)
    s2c = pkg.em.ThinEvalMapTree(ea, invert=False)
    c2s = pkg.em.ThinEvalMapTree(ea, invert=True)
    out.v = rng.integers(0, ctx.ptxt_space, ea.nslots)
    out.ct = ea.encrypt(list(out.v), pk, rng)
    out.thin_mid = s2c.apply(out.ct, sk)
    out.thin_out = c2s.apply(out.thin_mid, sk)
    inv = pkg.em.ThinEvalMapTree(ea, invert=True, fat=True)
    fwd = pkg.em.ThinEvalMapTree(ea, invert=False, fat=True)
    out.w = [rng.integers(0, ctx.ptxt_space, ea.d) for _ in range(ea.nslots)]
    ct = ea.encrypt(out.w, pk, rng)
    out.fat_mid = inv.apply(ct, sk)
    out.fat_out = fwd.apply(out.fat_mid, sk)
    out.fat_block = inv.stages[-1][0] == "blockmatmul" and inv._execs[-1]
    M = rng.integers(0, ctx.ptxt_space, (4, 4))
    mm = pkg.mm.MatMul1D(ea, 1, lambda i, j: int(M[i, j]))
    out.M = M
    out.matmul = {b: mm.apply(out.ct, sk, bsgs=b) for b in (False, True)}
    return out


@pytest.fixture(scope="module")
def maps255():
    rec = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jntt, "USE_PALLAS", False)
        _record(mp, rec)
        j = _maps255(JAX)
    return j, _maps255(PORT), rec


@pytest.mark.parametrize("step", ["thin_mid", "thin_out", "fat_mid",
                                  "fat_out"])
def test_evalmap_round_trip_equals_reference(maps255, step):
    j, t, _ = maps255
    _same(getattr(j, step), getattr(t, step))


def test_evalmap_round_trips_decrypt(maps255):
    j, t, _ = maps255
    for step in ("thin_mid", "thin_out", "fat_mid", "fat_out"):
        assert getattr(t, step).is_correct(), step
    np.testing.assert_array_equal(t.ea.decrypt_ints(t.thin_out, t.sk), t.v)
    for got, want in zip(t.ea.decrypt(t.fat_out, t.sk), t.w):
        np.testing.assert_array_equal(np.asarray(got) % t.ea.pr, want)


@pytest.mark.parametrize("bsgs", [False, True])
def test_matmul1d_equals_reference(maps255, bsgs):
    """MatMul1D along the dimension of order 4, both schedules: helib_tpu's
    residues and the slot-wise matrix product."""
    j, t, _ = maps255
    _same(j.matmul[bsgs], t.matmul[bsgs])
    pal, got = t.ctx.pal, t.ea.decrypt_ints(t.matmul[bsgs], t.sk)
    for s in range(t.ea.nslots):
        cs = list(pal.coords(s))
        col = []
        for e in range(4):
            cs[1] = e
            col.append(t.v[pal.slot_index(cs)])
        assert got[s] == int(t.M[pal.coords(s)[1]] @ col) % t.ea.pr


@pytest.mark.parametrize("cls", ["BlockMatMul1D", "trace_map"])
def test_recorded_stage_equals_reference(maps255, cls):
    """The fat inverse map's BlockMatMul1D stage and the thin inverse
    map's trace (hoisted: d = 8), on helib_tpu's recorded inputs."""
    j, t, rec = maps255
    if cls == "trace_map":
        ct, _, out = rec["trace_map"]
        got = _to_port(ct, t.sk.pubkey).trace_map(t.sk.pubkey)
    else:
        assert j.fat_block and t.fat_block
        ct, _, out = rec[("apply", id(j.fat_block))]
        got = t.fat_block.apply(_to_port(ct, t.sk.pubkey), t.sk.pubkey)
    _same(out, got)


# ---------------------------------------------------------------------------
# the full recrypts at composite m (slow)
# ---------------------------------------------------------------------------

def _recrypt(pkg, params, seed, hwt, fat):
    ctx = pkg.Context(**params, **pkg.kw)
    sk = pkg.SecKey(ctx, seed=seed, hwt=hwt)
    pk = pkg.PubKey(sk)
    ea = pkg.EA(ctx)
    cls = pkg.rc.FatRecryptData if fat else pkg.rc.RecryptData
    rc = cls(ctx, sk, ea, hwt=hwt)
    rng = np.random.default_rng(seed + 2)
    if fat:
        slots = [rng.integers(0, ctx.ptxt_space, ea.d)
                 for _ in range(ea.nslots)]
    else:
        slots = list(rng.integers(0, ctx.ptxt_space, ea.nslots))
    low = pk.encrypt_bgv(ea.encode(slots), rng)
    low.bring_to_k(3)
    fn = pkg.rc.fat_recrypt if fat else pkg.rc.thin_recrypt
    return fn(low, rc, sk), low, ea, sk, slots


@pytest.mark.slow
@pytest.mark.parametrize("params,seed,hwt,fat", [
    (dict(m=255, p=2, r=1, bits=950, c=3, mvec=(3, 5, 17)), 121, 24, False),
    (dict(m=255, p=2, r=1, bits=950, c=3, mvec=(3, 5, 17)), 131, 24, True),
    (dict(m=45, p=2, r=1, bits=800, c=3), 91, 20, False)],
    ids=["thin255", "fat255", "thin45"])
def test_full_recrypt_equals_reference(params, seed, hwt, fat, monkeypatch):
    """tests/test_bootstrap.py's composite-m recrypts (the tree maps with
    the powerful-basis rounding at m=255, the dense maps at m=45) in both
    packages: equal residues, exact decrypt, capacity gained."""
    monkeypatch.setattr(jntt, "USE_PALLAS", False)
    jout, *_ = _recrypt(JAX, params, seed, hwt, fat)
    out, low, ea, sk, slots = _recrypt(PORT, params, seed, hwt, fat)
    _same(jout, out)
    assert out.is_correct() and out.capacity() > low.capacity() + 30
    for got, want in zip(ea.decrypt(out, sk), slots):
        want = np.atleast_1d(want)
        np.testing.assert_array_equal(np.asarray(got)[:len(want)] % ea.pr,
                                      want)
