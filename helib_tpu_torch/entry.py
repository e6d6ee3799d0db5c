"""Entry points: the flagship step and the multi-rank dry run
(the port of helib_tpu's __graft_entry__.py)."""

from __future__ import annotations

import numpy as np
import torch

from .parallel.distributed import rank_device, world


def _small_ctx(bits: int = 150, device="cuda"):
    from .context import Context
    from .keys import SecKey
    # small odd-m BGV context exercising the general-m (Bluestein) path
    ctx = Context(m=45, p=2, r=1, bits=bits, c=3, scheme="bgv", device=device)
    return ctx, SecKey(ctx, seed=1)


def entry(device="cuda"):
    """(fn, example_args): the flagship step, BGV tensor product + hybrid
    key-switch relinearization + mod-down at m=45 (the inner loop of every
    homomorphic circuit)."""
    from .pipeline import make_mult_relin
    return make_mult_relin(*_small_ctx(device=device))


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(f"dry run: {what}")


def _same(a, b, what: str):
    _check(len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)),
           f"{what}: sharded != unsharded")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run on every rank of an n_devices-rank group: the sharded mult+relin
    and rotate over a ("batch", "limb") mesh, a phi(m)-axis four-step NTT,
    the m=31775 sharded Bluestein transform, a thin bootstrap at m=1271 and
    the m=31775 EvalMap and digit-extraction stages on the sharded
    transforms -- helib_tpu's dry run, with the same sizes, seeds and
    checks, each result held to the unsharded port on the same inputs."""
    import torch.distributed as dist
    from .parallel.mesh import (make_mesh, sharded_mult_relin,
                                sharded_automorph_relin)
    from .parallel.sharded_ntt import ShardedNTT, bluestein_apply_sharded
    from .pipeline import make_batched_mult_relin, make_automorph_relin
    from .nt.primegen import gen_primes, gen_aux_primes
    from .ops.ntt import Pow2NTT, BluesteinTables, aux_tree, bluestein_apply
    from .ops.ntt import ntt_pow2_fwd
    from .ops.modops import to_device

    _, size = world()
    if size != n_devices:
        raise ValueError(f"dry run on {n_devices} ranks, the group has "
                         f"{size}")
    device = rank_device(device)
    group = dist.group.WORLD if dist.is_initialized() else None
    mesh = make_mesh(n_devices)
    limb = mesh.shape["limb"]
    # bits chosen so the limb count divides over the limb axis
    ctx, sk = _small_ctx(bits=int(limb * 2 * 29.5), device=device)
    batch = mesh.shape["batch"] * 2
    fn, ex = sharded_mult_relin(ctx, sk, mesh, batch)
    got = [mesh.gather(o) for o in fn(*ex)]
    ufn, uex = make_batched_mult_relin(ctx, sk, batch)
    _same(got, ufn(*uex), "mult+relin")
    rfn, rex = sharded_automorph_relin(ctx, sk, mesh, batch)
    got = [mesh.gather(o) for o in rfn(*rex)]
    ufn, uex = make_automorph_relin(ctx, sk)
    _same(got, [o.expand((batch,) + o.shape) for o in ufn(*uex)],
          "automorph+relin")

    # phi(m)-axis sharding: one transform split A ways, the coarse stage's
    # gather the one exchange a direction
    A = n_devices
    n = max(256 * A, 2048)
    qs = np.array(gen_primes(2 * n, 2), dtype=np.uint32)
    s = ShardedNTT(qs, n, negacyclic=True, A=A, device=device)
    if group is not None:
        s.set_group(group)
    rng = np.random.default_rng(0)
    x = to_device(rng.integers(0, qs[:, None].astype(np.int64),
                               (2, n)).astype(np.uint32), device)
    lo, hi = s.span()
    y = s.fwd(x[..., lo:hi])
    ref = ntt_pow2_fwd(x, Pow2NTT(qs, n, negacyclic=True).tree(device))
    _same([s.gather(y)], [ref], "four-step forward")
    _same([s.gather(s.inv(y))], [x], "four-step inverse")

    # the reference-scale bootstrap transform, phi(m)-axis sharded: the
    # full-m DFT of an m=31775 row (three B=65536 convolutions) with the
    # four-step block axis split over the group
    mbig = 31775
    qs2 = np.array(gen_primes(2 * mbig, 2), dtype=np.uint32)
    bt = BluesteinTables(qs2, mbig, inverse=False, device=device)
    t2 = bt.tree(device, range(len(qs2)), aux_tree(bt.B, device))
    sntt = ShardedNTT(np.array(gen_aux_primes(3), dtype=np.uint32), bt.B,
                      negacyclic=False, A=A, device=device)
    if group is not None:
        sntt.set_group(group)
    xb = to_device(rng.integers(0, qs2[:, None].astype(np.int64),
                                (len(qs2), mbig)).astype(np.uint32), device)
    _same([bluestein_apply_sharded(xb, t2, mbig, bt.B, sntt)],
          [bluestein_apply(xb, t2, mbig, bt.B)], "m=31775 Bluestein")

    # a thin bootstrap at HElib's tiny thinboot size (m=1271) with every
    # transform on the sharded four-step pipeline: decrypts to its slots,
    # capacity restored
    from .context import Context
    from .keys import SecKey, PubKey
    from .ea import EncryptedArray
    from .recryption import RecryptData, thin_recrypt
    ctx_b = Context(m=1271, p=2, r=1, bits=360, c=3, scheme="bgv",
                    mvec=(31, 41), device=device)
    sk_b = SecKey(ctx_b, seed=141, hwt=64)
    pk_b = PubKey(sk_b)
    ea_b = EncryptedArray(ctx_b)
    rc = RecryptData(ctx_b, sk_b, ea_b, hwt=64)
    rng_b = np.random.default_rng(143)
    slots = list(rng_b.integers(0, 2, ea_b.nslots))
    ct = ea_b.encrypt(slots, pk_b, rng_b)
    ct.bring_to_k(3)                       # capacity nearly spent
    ctx_b.enable_sharded_transforms(A, group)
    out = thin_recrypt(ct, rc, sk_b)
    ctx_b.disable_sharded_transforms()
    got_slots = [int(v) for v in ea_b.decrypt_ints(out, sk_b)]
    _check(got_slots == [int(v) for v in slots],
           "sharded thin bootstrap: wrong decrypt")
    _check(out.capacity() > ct.capacity(),
           "sharded thin bootstrap: capacity not restored")

    # the m=31775 recrypt stages on the sharded transforms, bit-exact with
    # the unsharded path: the EvalMap factor-tree MatMul1Ds and the extract
    # ladder on a short chain (bits=210): the reference-scale ring shapes
    # (B=65536 convolutions over phi(m)=24000) in bounded time
    from .evalmap import ThinEvalMapTree
    from .recryption import extract_digits_thin, _encrypt_with_space
    ctx31 = Context(m=31775, p=2, r=1, bits=210, c=3, scheme="bgv",
                    mvec=(31, 25, 41), device=device)
    e31 = 3
    # the KS matrices carry the ladder's enlarged plaintext space, as
    # RecryptData arranges for the real recrypt
    ctx31.boot_ptxt_space = 2 ** (e31 + 1)
    sk31 = SecKey(ctx31, seed=41, hwt=64)
    ea31 = EncryptedArray(ctx31)
    tree31 = ThinEvalMapTree(ea31, invert=False)
    rng31 = np.random.default_rng(45)
    slots31 = list(rng31.integers(0, 2, ea31.nslots))
    pk31 = PubKey(sk31)
    ct31 = ea31.encrypt(slots31, pk31, rng31)
    lad31 = _encrypt_with_space(
        sk31, rng31.integers(0, 2 ** e31, ctx31.phi_m), 2 ** e31)

    def boot_stages():
        mapped = tree31.apply(ct31, sk31)
        extracted = extract_digits_thin(lad31.copy(), e31 - 1, 1, 0, sk31)
        return mapped, extracted

    ref_map, ref_ext = boot_stages()
    ctx31.enable_sharded_transforms(A, group)
    got_map, got_ext = boot_stages()
    ctx31.disable_sharded_transforms()
    for a, b, tag in ((ref_map, got_map, "evalmap"),
                      (ref_ext, got_ext, "extract")):
        key = lambda t: str(t[0])  # noqa: E731
        _check([h for h, _ in sorted(a.parts, key=key)]
               == [h for h, _ in sorted(b.parts, key=key)],
               f"m=31775 {tag}: parts")
        _same([d for _, d in sorted(a.parts, key=key)],
              [d for _, d in sorted(b.parts, key=key)], f"m=31775 {tag}")
