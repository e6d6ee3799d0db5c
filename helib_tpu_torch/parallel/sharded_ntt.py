"""phi(m)-axis sharding of one large NTT: the four-step split
(helib_tpu.parallel.sharded_ntt).

The n-point transform (n = A * nB) factors as

    out[b*nB + j] = sum_l W2[j, l] * ( tw[b, l] * sum_a W1[b, a] x[a*nB + l] )

      W1[b, a] = rho_b^a         (A x A   "coarse" block stage)
      tw[b, l] = sigma_b^l       (twist diagonal)
      W2[j, l] = zeta^{t(j) l}   (nB-point local transform, block-independent)

with rho_b = w^(nB * E[b*nB]), sigma_b = w^(E[b*nB]), zeta = w^(ord/nB) and
t(j) the within-block output order, all from the same splitting recursion
as ops.ntt.Pow2NTT, so the composition reproduces its `eval_exponents`
order bit for bit.  The tables are built with numpy, as helib_tpu builds
them, and kept on the device as int32 bit patterns.

Sharding: a group of A ranks splits the block axis, one block a rank.  The
coarse stage contracts over it, so each direction gathers the blocks once
(the transform's one exchange, 1x the tensor); the twist and the local
nB-point stages are block-local.  Without a group all A blocks stay here,
which is helib_tpu's meaning on one device.  These are torch ops, as
helib_tpu's are jnp ones; each four-step transform run (each direction
one) counts under "sharded" in ops._build.launch_counts, as the staged ones
count under "staged".
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..context import resolve_device
from ..ops._build import count
from ..ops.ntt import Pow2NTT, power_table, _stage_exponents
from ..ops.modops import (add_mod, sub_mod, mul_mod_shoup, shoup, reduce_u32,
                          to_device)
from ..nt.numbth import inv_mod
from ..exceptions import assert_true
from .distributed import all_gather


@dataclass
class ShardedNTT:
    """Four-step split of a Pow2NTT over qs, transform size n = A * nB,
    tables on `device`."""
    qs: np.ndarray
    n: int
    negacyclic: bool
    A: int
    device: torch.device | str = "cuda"
    dev: dict = field(init=False)
    group: object = field(init=False, default=None)
    blocks: tuple = field(init=False)        # this rank's blocks [b0, b1)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        n, A = self.n, self.A
        assert_true(n % A == 0 and A & (A - 1) == 0,
                    'invariant: n % A == 0 and A & (A - 1) == 0')
        nB = n // A
        qs = np.asarray(self.qs, dtype=np.uint64)
        P = len(qs)
        base = Pow2NTT(self.qs, n, negacyclic=self.negacyclic)
        ordr = 2 * n if self.negacyclic else n
        E = base.eval_exponents.astype(object) % ordr
        blk = np.asarray(E).reshape(A, nB)
        assert_true(((blk * nB) % ordr == (blk[:, :1] * nB) % ordr).all(),
                    'invariant: ((blk * nB) % ordr == (blk[:, :1] * nB) % '
                    'ordr).all()')
        step = ordr // nB
        tj = (blk - blk[:, :1]) % ordr
        assert_true((tj % step == 0).all(),
                    'invariant: (tj % step == 0).all()')
        tj = (tj // step).astype(np.int64)
        assert_true((tj == tj[0:1]).all(), "within-block order must be shared")
        # t(j) is the standalone nB recursion's order, so the local stage
        # tables below give exactly the same output ordering
        stage_exps, Eb = _stage_exponents(nB, 0, nB)
        assert_true(tj[0].tolist() == list(Eb), "local order mismatch")

        W1 = np.zeros((P, A, A), dtype=np.uint32)
        TW = np.zeros((P, A, nB), dtype=np.uint32)
        W1i = np.zeros((P, A, A), dtype=np.uint32)
        TWi = np.zeros((P, A, nB), dtype=np.uint32)
        loc_tw = [np.zeros((P, len(e)), np.uint32) for e in stage_exps]
        loc_itw = [np.zeros((P, len(e)), np.uint32) for e in stage_exps]
        ninv_loc = np.zeros((P, 1), dtype=np.uint32)
        for k, q in enumerate(qs):
            q = int(q)
            w = base.roots[k]
            zeta = pow(w, step, q)
            Ainv = inv_mod(A, q)
            for b in range(A):
                rho = pow(w, int(blk[b, 0] * nB) % ordr, q)
                sig = pow(w, int(blk[b, 0]) % ordr, q)
                W1[k, b] = power_table(rho, q, A)
                TW[k, b] = power_table(sig, q, nB)
                # inverse coarse matrix as W[a, b] = rho_b^{-a}, transposed
                # below
                W1i[k, b] = power_table(inv_mod(rho, q), q, A)
                TWi[k, b] = (power_table(inv_mod(sig, q), q, nB)
                             .astype(np.uint64) * np.uint64(Ainv)
                             % np.uint64(q)).astype(np.uint32)
            ninv_loc[k, 0] = inv_mod(nB, q)
            zp = power_table(zeta, q, nB)
            zpi = power_table(inv_mod(zeta, q), q, nB)
            for s, exps in enumerate(stage_exps):
                e = np.array(exps, dtype=np.int64) % nB
                loc_tw[s][k] = zp[e]
                loc_itw[s][k] = zpi[e]

        def pair(a):
            """(table, Shoup companions) on the device."""
            sh = shoup(a, qs.reshape((P,) + (1,) * (a.ndim - 1)))
            return to_device(a, self.device), to_device(sh, self.device)

        W1i = np.ascontiguousarray(W1i.transpose(0, 2, 1))
        self.dev = {
            "q": to_device(qs.astype(np.uint32)[:, None, None], self.device),
            "W1": pair(W1), "W1i": pair(W1i), "TW": pair(TW),
            "TWi": pair(TWi), "ltw": [pair(a) for a in loc_tw],
            "litw": [pair(a) for a in loc_itw],
            "ninv": pair(ninv_loc[:, None, :]),
        }
        self.blocks = (0, A)

    # ------------------------------------------------------------------
    def set_group(self, group):
        """Split the block axis over `group` (a torch.distributed group of A
        ranks): rank i of the group holds block i.  fwd and inv then take
        and return that block alone."""
        size = dist.get_world_size(group)
        assert_true(size == self.A, f"a group of {size} ranks for "
                    f"{self.A} blocks")
        self.group = group
        r = dist.get_rank(group)
        self.blocks = (r, r + 1)
        return self

    def span(self) -> tuple:
        """The columns [lo, hi) of the n-point axis this rank holds."""
        nB = self.n // self.A
        return self.blocks[0] * nB, self.blocks[1] * nB

    def gather(self, x, name: str = "ntt_result"):
        """This rank's columns of x [..., n_own] -> all n of them, the
        blocks of every rank of the group in order."""
        if self.group is None:
            return x
        return torch.cat(all_gather(x, self.group, name), dim=-1)

    def _coarse(self, x, W):
        """sum_a W[p, b, a] * x[..., p, a, l] (mod q) for this rank's output
        blocks b: x holds every block (gathered), the A passes are local."""
        q = self.dev["q"]
        b0, b1 = self.blocks
        w, wsh = W[0][:, b0:b1], W[1][:, b0:b1]
        acc = None
        for a in range(self.A):
            term = mul_mod_shoup(x[..., a:a + 1, :], w[:, :, a, None],
                                 wsh[:, :, a, None], q)
            acc = term if acc is None else add_mod(acc, term, q)
        return acc

    def _twist(self, x, T):
        b0, b1 = self.blocks
        return mul_mod_shoup(x, T[0][:, b0:b1], T[1][:, b0:b1], self.dev["q"])

    def _local(self, x, tw, inverse: bool):
        """Staged nB-point transform along the last axis (block-local)."""
        q = self.dev["q"][..., None]
        nB = self.n // self.A
        stages = range(len(tw))
        for s in (reversed(stages) if inverse else stages):
            m = 1 << s
            half = nB // (2 * m)
            w = tw[s][0][:, None, :, None]
            ws = tw[s][1][:, None, :, None]
            xr = x.reshape(*x.shape[:-1], m, 2, half)
            u, v = xr[..., 0, :], xr[..., 1, :]
            if inverse:
                u, v = add_mod(u, v, q), mul_mod_shoup(sub_mod(u, v, q), w,
                                                       ws, q)
            else:
                wv = mul_mod_shoup(v, w, ws, q)
                u, v = add_mod(u, wv, q), sub_mod(u, wv, q)
            x = torch.stack([u, v], dim=-2).reshape(*x.shape[:-1], nB)
        if inverse:
            x = mul_mod_shoup(x, *self.dev["ninv"], self.dev["q"])
        return x

    def _blocks(self, x):
        """[..., P, n_own] -> [..., P, blocks, nB]."""
        return x.reshape(*x.shape[:-1], -1, self.n // self.A)

    def fwd(self, x):
        """x [..., P, n_own]: this rank's columns of the coefficients ->
        its columns of the evaluations (Pow2NTT order).  The coarse stage
        gathers the blocks: the one exchange."""
        count("sharded")
        t = self.dev
        X = self._blocks(self.gather(x, "ntt_coarse"))
        S = self._twist(self._coarse(X, t["W1"]), t["TW"])
        S = self._local(S, t["ltw"], inverse=False)
        return S.reshape(*x.shape)

    def inv(self, y):
        """Inverse of fwd, mirrored: local stages, twist, then the gathered
        coarse stage."""
        count("sharded")
        t = self.dev
        S = self._local(self._blocks(y), t["litw"], inverse=True)
        S = self._twist(S, t["TWi"])
        S = self._blocks(self.gather(S.reshape(*y.shape), "ntt_coarse"))
        return self._coarse(S, t["W1i"]).reshape(*y.shape)


def _default_shards(B: int) -> int:
    """helib_tpu's default A: the device count, within [2, 8]; here the
    ranks of the default group."""
    from .distributed import world
    return min(8, max(2, world()[1]))


def sharded_bluestein_ntt(bt, device="cuda") -> ShardedNTT:
    """The phi(m)-axis four-step transform for the length-B auxiliary
    convolutions of a BluesteinTables instance (the large-m bootstrap
    transform: at m=31775 one forward DFT is three B=65536 convolutions a
    limb row)."""
    from ..ops.ntt import aux_primes
    return ShardedNTT(aux_primes(), bt.B, negacyclic=False,
                      A=_default_shards(bt.B), device=device)


def bluestein_apply_sharded(x, t, m: int, B: int, sntt: ShardedNTT):
    """ops.ntt.bluestein_apply with its B-point convolutions on the
    phi(m)-axis four-step transform.  x: [..., P, m] residues, replicated on
    every rank; t: a Bluestein tree (Context.ntt_tree).  Each rank lifts x
    onto the auxiliary primes, takes its block of the [..., P, 3, B] lift,
    convolves it (fwd, the pointwise khat multiply, inv: one exchange each
    way) and runs the CRT tail on it; one more gather leaves the result
    replicated for the ring ops around it.  Bit-exact with bluestein_apply
    (khat is in Pow2NTT order, which fwd reproduces); the float32 lift sums
    its three terms left to right, as bluestein_apply does.

    Collective volume a call: 3 * B words a limb row each way and B words a
    row for the last gather."""
    q = t["q"]
    aux_q = t["aux_q"].reshape(3, 1)
    a = mul_mod_shoup(x, t["u_in"], t["u_in_sh"], q)          # [..., P, m]
    a3 = F.pad(reduce_u32(a.unsqueeze(-2), aux_q), (0, B - m))  # [..., P, 3, B]
    lo, hi = sntt.span()
    kh = t["khat"].transpose(0, 1)[..., lo:hi]                # [P, 3, n_own]
    khs = t["khat_sh"].transpose(0, 1)[..., lo:hi]
    p = sntt.inv(mul_mod_shoup(sntt.fwd(a3[..., lo:hi]), kh, khs, aux_q))
    y = mul_mod_shoup(p, t["yt_inv"].reshape(3, 1),
                      t["yt_inv_sh"].reshape(3, 1), aux_q)
    yf = y.to(torch.float32)
    r = t["inv_r_f32"]
    s = yf[..., 0, :] * r[0]
    s = s + yf[..., 1, :] * r[1]
    s = s + yf[..., 2, :] * r[2]
    alpha = torch.floor(s + 0.25).to(torch.int32)            # [..., P, n_own]
    terms = mul_mod_shoup(y, t["Rt_mod_q"].transpose(0, 1),
                          t["Rt_mod_q_sh"].transpose(0, 1), q.unsqueeze(-1))
    acc = add_mod(add_mod(terms[..., 0, :], terms[..., 1, :], q),
                  terms[..., 2, :], q)
    V = add_mod(acc, mul_mod_shoup(alpha, t["negR"], t["negR_sh"], q), q)
    V = sntt.gather(V)[..., :m]
    return mul_mod_shoup(V, t["u_out"], t["u_out_sh"], q)
