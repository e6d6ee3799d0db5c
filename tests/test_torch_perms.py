"""Port vs helib_tpu, encrypted, on the host CPU: the homomorphic
permutation networks -- optimize_perms' PermPrecomp.apply at m=31 (one bad
dimension of order 6) and at m=63 (a native dimension), on the matrices
add_matrices_4_network mints, the displacement PermPrecomp and
apply_permutation, BenesNetwork.apply -- the random_matrices generators, and
MatMulCKKS at CKKS m=256 with BSGS on and off.  Each package runs the same
seeded keys and encryptions; the minted matrices and every output
ciphertext must be equal residue for residue, and every output decrypts to
the numpy oracle (CKKS: within 4 x error_bound() of M @ z)."""

import types

import numpy as np
import pytest
import torch

from helib_tpu import ksstrategy as jks
from helib_tpu.algos import benes as jbenes, matmul_ckks as jmc
from helib_tpu.algos import optimize_perms as jop, permutations as jperm
from helib_tpu.algos import random_matrices as jrm
from helib_tpu.ckks import EncryptedArrayCKKS as JCKKS
from helib_tpu.context import Context as JContext
from helib_tpu.ea import EncryptedArray as JEA
from helib_tpu.keys import SecKey as JSecKey, PubKey as JPubKey
from helib_tpu.keys import SKHandle as JSKHandle
from helib_tpu.ops import ntt as jntt

from helib_tpu_torch import ksstrategy as tks
from helib_tpu_torch.algos import benes as tbenes, matmul_ckks as tmc
from helib_tpu_torch.algos import optimize_perms as top, permutations as tperm
from helib_tpu_torch.algos import random_matrices as trm
from helib_tpu_torch.ckks import EncryptedArrayCKKS as TCKKS
from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.ea import EncryptedArray as TEA
from helib_tpu_torch.keys import SecKey as TSecKey, PubKey as TPubKey
from helib_tpu_torch.keys import SKHandle as TSKHandle
from helib_tpu_torch.ops.modops import to_host

torch.set_num_threads(1)

JAX = types.SimpleNamespace(Context=JContext, EA=JEA, CKKS=JCKKS,
                            SecKey=JSecKey, PubKey=JPubKey, ks=jks, op=jop,
                            perm=jperm, benes=jbenes, rm=jrm, mc=jmc,
                            SKHandle=JSKHandle, kw={})
PORT = types.SimpleNamespace(Context=TContext, EA=TEA, CKKS=TCKKS,
                             SecKey=TSecKey, PubKey=TPubKey, ks=tks, op=top,
                             perm=tperm, benes=tbenes, rm=trm, mc=tmc,
                             SKHandle=TSKHandle, kw={"device": "cpu"})

# m, PermIndepPrecomp depth bound, key seed, data seed (test_optimize_perms)
NETWORKS = {31: (3, 79, 83), 63: (4, 77, 79)}
CKKS256 = dict(m=256, p=-1, r=30, bits=240, c=3, scheme="ckks")


def _network(pkg, m):
    """The optimized network on its own minted matrices, then (m=31) the
    displacement network, the Benes network and the random matrices on the
    same keys."""
    depth, kseed, dseed = NETWORKS[m]
    ctx = pkg.Context(m=m, p=2, r=1, bits=500, c=3, **pkg.kw)
    sk = pkg.SecKey(ctx, seed=kseed)
    pk = pkg.PubKey(sk)
    ea = pkg.EA(ctx)
    pip = pkg.op.PermIndepPrecomp(ea, depth)
    rng = np.random.default_rng(dseed)
    perm = rng.permutation(ea.nslots)
    pp = pkg.op.PermPrecomp(pip, perm)
    pkg.ks.add_matrices_4_network(sk, pp)
    minted = dict(sk.matrices)
    s = rng.integers(0, 2, ea.nslots)
    ct = ea.encrypt(list(s), pk, rng)
    out = {"optimized": pp.apply(ct, pk)}
    clear = {"optimized": s[perm]}
    if m == 31:
        out["displacement"] = pkg.perm.apply_permutation(ea, ct, perm, sk)
        out["displacement_pre"] = pkg.perm.PermPrecomp(ea, perm).apply(ct,
                                                                      sk)
        clear["displacement"] = clear["displacement_pre"] = s[perm]
        bperm = rng.permutation(ea.nslots)
        out["benes"] = pkg.benes.BenesNetwork(bperm).apply(ea, ct, sk)
        clear["benes"] = s[bperm]
        mat, M = pkg.rm.random_matmul1d(ea, 0, rng, zero_frac=0.3)
        out["matmul1d"] = mat.apply(ct, sk)
        clear["matmul1d"] = M @ s % 2
        mat, M = pkg.rm.random_matmul_full(ea, rng)
        out["matmul_full"] = mat.apply(ct, sk)
        clear["matmul_full"] = M @ s % 2
    return out, minted, (ctx, sk, ea, pp, clear)


def _ckks(pkg):
    """MatMulCKKS on a dense real matrix, with BSGS and without."""
    ctx = pkg.Context(**CKKS256, **pkg.kw)
    sk = pkg.SecKey(ctx, seed=9)
    pk = pkg.PubKey(sk)
    ea = pkg.CKKS(ctx)
    rng = np.random.default_rng(11)
    M = rng.uniform(-1, 1, (ea.nslots, ea.nslots))
    z = rng.uniform(-1, 1, ea.nslots)
    ct = ea.encrypt(z, pk, np.random.default_rng(12))
    # every rotation minted first, as a user would (a missing one is reached
    # by hops through the minted ones, one key switch a hop)
    inv5 = pow(5, -1, ctx.m)
    for amt in range(1, ea.nslots):
        sk.gen_ks_matrix(pkg.SKHandle(1, pow(inv5, amt, ctx.m), 0))
    mm = pkg.mc.MatMulCKKS(ea, lambda i, j: M[i, j])
    out = {"ckks_bsgs": mm.apply(ct, sk, bsgs=True),
           "ckks_plain": mm.apply(ct, sk, bsgs=False)}
    return out, (ea, sk, M @ z)


@pytest.fixture(scope="module")
def runs():
    jout, tout, jmint, tmint, held = {}, {}, {}, {}, {}
    for m in NETWORKS:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jntt, "USE_PALLAS", False)
            j, jmint[m], _ = _network(JAX, m)
        t, tmint[m], held[m] = _network(PORT, m)
        jout.update({f"{k}{m}": v for k, v in j.items()})
        tout.update({f"{k}{m}": v for k, v in t.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jntt, "USE_PALLAS", False)
        j, _ = _ckks(JAX)
    t, held["ckks"] = _ckks(PORT)
    jout.update(j)
    tout.update(t)
    return jout, tout, jmint, tmint, held


def _same(j, t):
    """Equal residues, handles and level metadata."""
    assert (t.k, t.special, t.ptxt_space) == (j.k, j.special, j.ptxt_space)
    assert abs(t.noise - j.noise) <= 1e-9
    assert [(h.powS, h.powX, h.keyID) for h, _ in t.parts] == [
        (h.powS, h.powX, h.keyID) for h, _ in j.parts]
    for (_, x), (_, y) in zip(t.parts, j.parts):
        np.testing.assert_array_equal(to_host(x), np.asarray(y))


BGV = ["optimized31", "displacement31", "displacement_pre31", "benes31",
       "matmul1d31", "matmul_full31", "optimized63"]
CKKS = ["ckks_bsgs", "ckks_plain"]


@pytest.mark.parametrize("name", BGV + CKKS)
def test_network_residues_equal_reference(runs, name):
    jout, tout = runs[:2]
    _same(jout[name], tout[name])


@pytest.mark.parametrize("name", BGV)
def test_network_decrypts_to_oracle(runs, name):
    m = int(name[-2:])
    ctx, sk, ea, _, clear = runs[4][m]
    ct = runs[1][name]
    assert ct.is_correct(), ct.capacity()
    np.testing.assert_array_equal(ea.decrypt_ints(ct, sk), clear[name[:-2]])


@pytest.mark.parametrize("m", sorted(NETWORKS))
def test_add_matrices_4_network_mints_the_reference_matrices(runs, m):
    """Exactly helib_tpu's matrices, bit for bit, one per (dimension,
    amount) the network needs (two on a bad dimension), and the network's
    apply with the PubKey reads no other."""
    jmint, tmint = runs[2][m], runs[3][m]
    assert list(tmint) == list(jmint)
    for key, W in tmint.items():
        J = jmint[key]
        assert (W.prg_seed, W.noise) == (J.prg_seed, J.noise)
        for a, b in zip(W.b + W.a, J.b + J.a):
            np.testing.assert_array_equal(to_host(a), np.asarray(b))
    ctx, sk, ea, pp, _ = runs[4][m]
    pal = ctx.pal
    want = set()
    for dim, amt in pp.needed_rotations():
        g, D = int(pal.gens[dim]), int(pal.orders[dim])
        want.add(pow(g, int(amt) % D, ctx.m))
        if not pal.native[dim]:
            want.add(pow(g, int(amt) % D - D, ctx.m))
    assert {key[1] for key in tmint} == want
    assert (m == 63) == any(pal.native)


@pytest.mark.parametrize("name", CKKS)
def test_matmul_ckks_within_error_bound(runs, name):
    ea, sk, want = runs[4]["ckks"]
    ct = runs[1][name]
    got = ea.decrypt(ct, sk)
    err = float(np.max(np.abs(got - want)))
    assert err <= 4 * ct.error_bound(), (err, ct.error_bound())
