"""Port vs helib_tpu: the parallel layer on torch.distributed, bit for bit.

The phi(m)-axis four-step transform (ShardedNTT, fwd and inv, cyclic and
negacyclic) and bluestein_apply_sharded with all blocks local (helib_tpu's
meaning on one device), Context.enable_sharded_transforms at m=45, and one
two-rank gloo run on the CPU: the sharded mult+relin on (1, 2) and (2, 1)
meshes, the sharded rotate and a ShardedNTT with its blocks split over the
two ranks, each gathered and held to helib_tpu's unsharded result on the
same inputs.  The four-rank dry run (entry.dryrun_multichip) is `slow`.

helib_tpu is imported inside the tests: the ranks are spawned processes
that import this module, and need neither JAX nor helib_tpu.
"""

import numpy as np
import pytest
import torch

from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.keys import SecKey as TSecKey
from helib_tpu_torch.nt.primegen import gen_primes, gen_aux_primes
from helib_tpu_torch.ops.modops import to_device, to_host
from helib_tpu_torch.ops.ntt import (Pow2NTT, ntt_pow2_fwd, BluesteinTables,
                                     aux_tree, bluestein_apply)
from helib_tpu_torch.parallel import distributed, mesh as tmesh
from helib_tpu_torch.parallel import sharded_ntt as tsn

torch.set_num_threads(1)

M45_BITS = int(2 * 2 * 29.5)       # the dry run's bits on a 2-way limb axis


def _residues(qs, shape, seed):
    rng = np.random.default_rng(seed)
    qs = np.asarray(qs, dtype=np.int64).reshape((-1,) + (1,) * (len(shape) - 1))
    return rng.integers(0, qs, shape).astype(np.uint32)


@pytest.mark.parametrize("n,negacyclic", [(512, True), (512, False),
                                          (2048, True)])
def test_sharded_ntt_matches_helib_tpu_and_pow2ntt(n, negacyclic):
    import jax
    import jax.numpy as jnp
    from helib_tpu.parallel.sharded_ntt import ShardedNTT as JShardedNTT
    qs = np.array(gen_primes(2 * n, 2), dtype=np.uint32)
    x = _residues(qs, (2, n), seed=n + negacyclic)
    s = tsn.ShardedNTT(qs, n, negacyclic=negacyclic, A=8, device="cpu")
    js = JShardedNTT(qs, n, negacyclic=negacyclic, A=8)
    before = tsn.sharded_transforms
    got = s.fwd(to_device(x, "cpu"))
    np.testing.assert_array_equal(to_host(got),
                                  np.asarray(jax.jit(js.fwd)(jnp.asarray(x))))
    ref = ntt_pow2_fwd(to_device(x, "cpu"),
                       Pow2NTT(qs, n, negacyclic=negacyclic).tree("cpu"))
    assert torch.equal(got, ref)
    back = s.inv(got)
    np.testing.assert_array_equal(to_host(back), x)
    np.testing.assert_array_equal(
        to_host(back),
        np.asarray(jax.jit(js.inv)(jnp.asarray(to_host(got)))))
    assert tsn.sharded_transforms == before + 2


@pytest.mark.parametrize("inverse", [False, True])
def test_bluestein_apply_sharded_matches_helib_tpu(inverse, monkeypatch):
    import jax
    import jax.numpy as jnp
    from helib_tpu.ops import ntt as jntt
    from helib_tpu.parallel.sharded_ntt import (
        ShardedNTT as JShardedNTT, bluestein_apply_sharded as jbas)
    monkeypatch.setattr(jntt, "USE_PALLAS", False)
    m = 255                       # B = 512, A = 8 blocks of 64
    qs = np.array(gen_primes(2 * m, 2), dtype=np.uint32)
    aux = np.array(gen_aux_primes(3), dtype=np.uint32)
    x = _residues(qs, (len(qs), m), seed=5 + inverse)
    jbt = jntt.BluesteinTables(qs, m, inverse=inverse)
    js = JShardedNTT(aux, jbt.B, negacyclic=False, A=8)
    want = np.asarray(jax.jit(lambda v: jntt.bluestein_apply(
        v, jbt.dev, m, jbt.B))(jnp.asarray(x)))
    np.testing.assert_array_equal(np.asarray(jax.jit(lambda v: jbas(
        v, jbt.dev, m, jbt.B, js))(jnp.asarray(x))), want)
    bt = BluesteinTables(qs, m, inverse=inverse)
    t = bt.tree("cpu", range(len(qs)), aux_tree(bt.B, "cpu"))
    s = tsn.ShardedNTT(aux, bt.B, negacyclic=False, A=8, device="cpu")
    got = tsn.bluestein_apply_sharded(to_device(x, "cpu"), t, m, bt.B, s)
    np.testing.assert_array_equal(to_host(got), want)
    assert torch.equal(got, bluestein_apply(to_device(x, "cpu"), t, m, bt.B))


def test_enable_sharded_transforms_m45_matches_helib_tpu():
    from helib_tpu.context import Context as JContext
    from helib_tpu.keys import SecKey as JSecKey
    from helib_tpu.pipeline import make_mult_relin as jmake
    from helib_tpu_torch.pipeline import make_mult_relin
    ctx = TContext(m=45, p=2, r=1, bits=150, c=3, device="cpu")
    fn, ex = make_mult_relin(ctx, TSecKey(ctx, seed=1))
    plain = fn(*ex)
    ctx.enable_sharded_transforms(4)
    before = tsn.sharded_transforms
    sharded = fn(*ex)
    moved = tsn.sharded_transforms - before
    ctx.disable_sharded_transforms()
    assert moved > 0
    jctx = JContext(m=45, p=2, r=1, bits=150, c=3, scheme="bgv")
    jfn, jex = jmake(jctx, JSecKey(jctx, seed=1))
    for a, b in zip(ex, jex):
        np.testing.assert_array_equal(to_host(a), np.asarray(b))
    for a, b, c in zip(sharded, plain, jfn(*jex)):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(to_host(a), np.asarray(c))


def test_mesh_shape_logic_at_world_size_1():
    m = tmesh.make_mesh()
    assert m.shape == {"batch": 1, "limb": 1} and m.coords == (0, 0)
    assert m.limb_group is None and m.batch_group is None
    g = distributed.global_mesh()
    assert g.shape == {"batch": 1, "limb": 1}
    assert tmesh.LimbShard(m, 5).own == (0, 1, 2, 3, 4)
    x = torch.arange(24, dtype=torch.int32).reshape(2, 3, 4)
    assert torch.equal(distributed.put_global(m, x), x)
    assert torch.equal(distributed.gather_global(m, x), x)
    with pytest.raises(Exception):
        tmesh.make_mesh(2)
    # helib_tpu's default block count: the ranks, within [2, 8]
    bt = BluesteinTables(np.array(gen_primes(2 * 45, 1), dtype=np.uint32),
                         45, inverse=False)
    s = tsn.sharded_bluestein_ntt(bt, device="cpu")
    assert (s.A, s.n, s.negacyclic, s.blocks) == (2, 128, False, (0, 2))


def test_sharded_ntt_entry_points_default_to_the_card():
    # like every entry point of the port: device="cuda" unless the caller
    # asks for the host, and without a card the error Context raises
    bt = BluesteinTables(np.array(gen_primes(2 * 45, 1), dtype=np.uint32),
                         45, inverse=False)
    qs = np.array(gen_primes(2 * 64, 2), dtype=np.uint32)
    if torch.cuda.is_available():
        assert tsn.ShardedNTT(qs, 64, True, A=2).device.type == "cuda"
        assert tsn.sharded_bluestein_ntt(bt).device.type == "cuda"
        return
    with pytest.raises(RuntimeError) as ctx_err:
        TContext(m=45, p=2, r=1, bits=120, c=3)
    for make in (lambda: tsn.ShardedNTT(qs, 64, True, A=2),
                 lambda: tsn.sharded_bluestein_ntt(bt)):
        with pytest.raises(RuntimeError) as err:
            make()
        assert str(err.value) == str(ctx_err.value)


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

def _two_ranks():
    """Run on each rank: the m=45 sharded pipelines on both mesh shapes and
    a ShardedNTT split over the group, every result gathered."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    ctx = TContext(m=45, p=2, r=1, bits=M45_BITS, c=3, device="cpu")
    sk = TSecKey(ctx, seed=1)
    out = {}
    for batch_axis in (1, 2):
        mesh = tmesh.make_mesh(2, batch_axis)
        fn, ex = tmesh.sharded_mult_relin(ctx, sk, mesh, 2)
        out[f"mult_{batch_axis}"] = [to_host(mesh.gather(o))
                                     for o in fn(*ex)]
        out[f"shape_{batch_axis}"] = tuple(ex[0].shape)
    mesh = tmesh.make_mesh(2, 1)
    rfn, rex = tmesh.sharded_automorph_relin(ctx, sk, mesh, 2)
    out["rotate"] = [to_host(mesh.gather(o)) for o in rfn(*rex)]
    n = 512
    qs = np.array(gen_primes(2 * n, 2), dtype=np.uint32)
    s = tsn.ShardedNTT(qs, n, negacyclic=True, A=2,
                       device="cpu").set_group(dist.group.WORLD)
    lo, hi = s.span()
    x = to_device(_residues(qs, (2, n), seed=7), "cpu")
    y = s.fwd(x[..., lo:hi])
    out["ntt"] = [to_host(s.gather(y)), to_host(s.gather(s.inv(y)))]
    out["collectives"] = distributed.read_collectives()
    return out


@pytest.fixture(scope="module")
def two_ranks():
    return distributed.launch(_two_ranks, 2, backend="gloo", timeout=300)


@pytest.fixture(scope="module")
def helib_ref():
    """helib_tpu's unsharded mult+relin and rotate at the same size, on
    the same inputs (the port's example arguments are checked equal)."""
    import jax
    from helib_tpu.context import Context as JContext
    from helib_tpu.keys import SecKey as JSecKey
    from helib_tpu.pipeline import make_mult_relin, make_automorph_relin
    from helib_tpu_torch.pipeline import random_parts
    ctx = JContext(m=45, p=2, r=1, bits=M45_BITS, c=3, scheme="bgv")
    sk = JSecKey(ctx, seed=1)
    fn, ex = make_mult_relin(ctx, sk)
    rfn, rex = make_automorph_relin(ctx, sk)
    tctx = TContext(m=45, p=2, r=1, bits=M45_BITS, c=3, device="cpu")
    for a, b in zip(random_parts(tctx, tctx.L, 4), ex):
        np.testing.assert_array_equal(to_host(a), np.asarray(b))
    return ([np.asarray(o) for o in jax.jit(fn)(*ex)],
            [np.asarray(o) for o in jax.jit(rfn)(*rex)])


@pytest.mark.parametrize("batch_axis", [1, 2])
def test_two_rank_sharded_mult_relin_matches_helib_tpu(two_ranks, helib_ref,
                                                       batch_axis):
    for rank, res in enumerate(two_ranks):
        # at rest each rank holds [batch/b, L/l, N]
        assert res[f"shape_{batch_axis}"] == (2 // batch_axis,
                                              4 // (2 // batch_axis), 45)
        for got, want in zip(res[f"mult_{batch_axis}"], helib_ref[0]):
            assert got.shape == (2,) + want.shape
            for b in range(2):
                np.testing.assert_array_equal(got[b], want)


def test_two_rank_sharded_rotate_matches_helib_tpu(two_ranks, helib_ref):
    for res in two_ranks:
        for got, want in zip(res["rotate"], helib_ref[1]):
            for b in range(2):
                np.testing.assert_array_equal(got[b], want)


def test_two_rank_sharded_ntt_matches_pow2ntt(two_ranks):
    n = 512
    qs = np.array(gen_primes(2 * n, 2), dtype=np.uint32)
    x = _residues(qs, (2, n), seed=7)
    ref = to_host(ntt_pow2_fwd(to_device(x, "cpu"),
                               Pow2NTT(qs, n, negacyclic=True).tree("cpu")))
    for res in two_ranks:
        np.testing.assert_array_equal(res["ntt"][0], ref)
        np.testing.assert_array_equal(res["ntt"][1], x)


def test_two_rank_exchanges_are_the_digit_and_coarse_gathers(two_ranks):
    """Across limbs only the digit rows move: the (1, 2) mesh's mult+relin
    and rotate gather each of the c = 3 digit blocks once (L = 4 rows,
    N = 45, batch 2, a block padded to 1 row a rank at most), the (2, 1)
    mesh none; the four-step gathers once a direction, twice for results."""
    for res in two_ranks:
        c = res["collectives"]
        # 3 digit blocks x (mult+relin on (1, 2), rotate on (1, 2))
        assert c["digit_rows"]["count"] == 6
        assert c["ntt_coarse"]["count"] == 2
        assert c["ntt_result"]["count"] == 2


@pytest.mark.slow
def test_dryrun_multichip_four_gloo_ranks():
    """The twin of tests/test_entry.py::test_dryrun_multichip: the whole
    dry run on four gloo CPU ranks."""
    from helib_tpu_torch.entry import dryrun_multichip
    distributed.launch(dryrun_multichip, 4, 4, "cpu", backend="gloo",
                       timeout=3600)
