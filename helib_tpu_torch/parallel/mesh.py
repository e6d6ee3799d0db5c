"""Device meshes and sharded ciphertext pipelines (helib_tpu.parallel.mesh).

A ("batch", "limb") grid over the ranks of the default process group:

  * axis "batch": data parallelism over independent ciphertexts,
  * axis "limb" : the RNS tower axis.  Each rank holds [batch/b, k/l, N] of
    every part tensor: a contiguous block of the k ciphertext rows.

Where the exchanges go.  The tensor product, every elementwise ring op, the
automorphism and the key-switch MAC are limb-local.  Two steps cross limbs:

  * the digit basis extension (dcrt.rt_break_into_digits): the coefficient
    rows of the key-switched part are all-gathered over the limb group,
    digit block by digit block (the rows of digit j depend on digits < j,
    so each block is gathered once its owners have it); each rank then
    extends every digit onto its own rows and the special primes only;
  * the special-prime mod-down (dcrt.rt_scale_down via
    Ctxt.drop_special_primes): the special rows are computed on every rank
    (replicated) and each rank lifts them onto its own rows; no exchange.

helib_tpu gets the same program from GSPMD; here the pipelines are
pipeline.py's own functions on a Ctxt that carries a LimbShard.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..context import Context
from ..keys import SecKey
from ..pipeline import make_batched_mult_relin, make_automorph_relin
from ..exceptions import InvalidArgument
from .distributed import all_gather, world


class Mesh:
    """The ranks of the default group as a [batch, limb] grid, rank
    b * limb + i at (b, i), with one subgroup per row (the limb group) and
    per column (the batch group); an axis of one rank has none.  Without a
    process group it is the (1, 1) mesh of this process alone."""

    def __init__(self, batch: int, limb: int):
        rank, size = world()
        if batch * limb != size:
            raise InvalidArgument(f"a {batch} x {limb} mesh needs "
                                  f"{batch * limb} ranks, the group has "
                                  f"{size}")
        self.shape = {"batch": batch, "limb": limb}
        self.coords = divmod(rank, limb)
        # one subgroup per row (limb) and column (batch) of more than one
        # rank; every rank creates every subgroup, in the same order
        self.limb_group = self.batch_group = None
        for b in range(batch if limb > 1 else 0):
            g = dist.new_group([b * limb + i for i in range(limb)])
            if b == self.coords[0]:
                self.limb_group = g
        for i in range(limb if batch > 1 else 0):
            g = dist.new_group([b * limb + i for b in range(batch)])
            if i == self.coords[1]:
                self.batch_group = g

    def rows(self, k: int) -> tuple:
        """This rank's ciphertext rows of a level-k part."""
        limb = self.shape["limb"]
        if k % limb:
            raise InvalidArgument(f"{k} rows do not split over a limb axis "
                                  f"of {limb}")
        i, n = self.coords[1], k // limb
        return tuple(range(i * n, (i + 1) * n))

    def put(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole [batch, k, N] tensor."""
        batch = self.shape["batch"]
        if x.shape[0] % batch:
            raise InvalidArgument(f"a batch of {x.shape[0]} does not split "
                                  f"over a batch axis of {batch}")
        n = x.shape[0] // batch
        b = self.coords[0]
        rows = self.rows(x.shape[-2])
        return x[b * n:(b + 1) * n, rows[0]:rows[-1] + 1].contiguous()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's shard (for checks)."""
        if not dist.is_initialized():
            return x
        parts = all_gather(x, None, "gather_global")
        limb = self.shape["limb"]
        return torch.cat([torch.cat(parts[b * limb:(b + 1) * limb], dim=-2)
                          for b in range(self.shape["batch"])], dim=0)


class LimbShard:
    """One rank's rows of a level-k ciphertext on a mesh: `own`, a
    contiguous block of the k ctxt rows, and `gather`, the limb group's
    exchange of coefficient rows that dcrt.rt_break_into_digits calls."""

    def __init__(self, mesh: Mesh, k: int):
        self.mesh = mesh
        self.own = mesh.rows(k)
        limb = mesh.shape["limb"]
        n = k // limb
        self._spans = [(i * n, (i + 1) * n) for i in range(limb)]

    def gather(self, s: int, e: int, x: torch.Tensor) -> torch.Tensor:
        """Rows [s, e) of the whole value from each rank's rows of that range
        (x: this rank's); ranks holding fewer rows than the most pad with
        zeros, which are dropped again."""
        group = self.mesh.limb_group
        if group is None:
            return x
        counts = [max(0, min(e, hi) - max(s, lo)) for lo, hi in self._spans]
        width = max(counts)
        if x.shape[-2] < width:
            pad = x.new_zeros(x.shape[:-2] + (width - x.shape[-2],
                                              x.shape[-1]))
            x = torch.cat([x, pad], dim=-2)
        parts = all_gather(x, group, "digit_rows")
        return torch.cat([p[..., :c, :] for p, c in zip(parts, counts)],
                         dim=-2)


def make_mesh(n_devices: int | None = None, batch_axis: int | None = None
              ) -> Mesh:
    """A ("batch", "limb") mesh over the n_devices ranks of the default
    group (all of them by default): limb up to 4 ways, batch for the rest,
    unless batch_axis is given."""
    _, size = world()
    n = n_devices or size
    if n != size:
        raise InvalidArgument(f"a mesh spans the whole group: {n} ranks "
                              f"asked for, the group has {size}")
    if batch_axis is None:
        batch_axis = n // min(4, n)
    return Mesh(batch_axis, n // batch_axis)


def sharded_mult_relin(ctx: Context, sk: SecKey, mesh: Mesh, batch: int):
    """Batched mult+relin with [batch, limb, N] sharding: (fn, example
    arguments), fn mapping this rank's shards of the four input parts to
    its shards of the two output parts, the arguments this rank's shards of
    pipeline.make_batched_mult_relin's."""
    shard = LimbShard(mesh, ctx.L)
    fn, ex = make_batched_mult_relin(ctx, sk, batch, shard=shard)
    return fn, tuple(mesh.put(e) for e in ex)


def sharded_automorph_relin(ctx: Context, sk: SecKey, mesh: Mesh, batch: int,
                            kexp: int | None = None):
    """Batched rotate (automorph + key switch) with [batch, limb, N]
    sharding: the automorphism's gather along N stays limb-local; the key
    switch's digit basis extension is the cross-limb exchange."""
    shard = LimbShard(mesh, ctx.L)
    fn, ex = make_automorph_relin(ctx, sk, kexp, shard=shard)
    bex = tuple(e.unsqueeze(0).expand((batch,) + e.shape) for e in ex)
    return fn, tuple(mesh.put(e) for e in bex)
