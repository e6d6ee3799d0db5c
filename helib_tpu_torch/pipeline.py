"""Ciphertext pipelines (helib_tpu.pipeline).

The hot sequence of every BGV circuit -- tensor product, digit
decomposition, key-switch MAC, mod-down -- as one callable on part tensors.
PyTorch runs it eagerly; batching is the leading dims that every ring op
broadcasts over, so the batched pipeline is the same function on
[batch, k, N] tensors.
"""

from __future__ import annotations

import math

import numpy as np

from .context import Context, log2_add
from .keys import SecKey, PubKey, SKHandle
from .ctxt import Ctxt
from .ops.modops import to_device


def mult_relin(ctx: Context, pk: PubKey, key, noise: float, k: int,
               c0_0, c0_1, c1_0, c1_1) -> Ctxt:
    """The relinearized product of two canonical ciphertexts at level k
    (given as their part tensors), special primes dropped.  The mod-switch
    noise is not measured (no host round trip), as in helib_tpu's traced
    pipeline, so the result's noise equals the jitted reference's."""
    def mk(a, b):
        return Ctxt(ctx, pk, [(SKHandle(0, 1, 0), a), (SKHandle(1, 1, 0), b)],
                    k, False, ctx.ptxt_space, noise, 1)
    out = mk(c0_0, c0_1).tensor(mk(c1_0, c1_1))
    out.relinearize(key)
    out.drop_special_primes(measure=False)
    return out


def make_mult_relin(ctx: Context, sk: SecKey, k: int | None = None,
                    noise: float | None = None):
    """Returns (fn, example_args): fn maps the four part tensors of two
    canonical ciphertexts at level k to the two part tensors of their
    relinearized product (with special primes dropped)."""
    k = k if k is not None else ctx.L
    pk = sk.pubkey or PubKey(sk)
    sk.gen_ks_matrix(SKHandle(2, 1, 0))
    # inputs carry a real fresh-encryption noise bound (see fresh_noise)
    noise = noise if noise is not None else fresh_noise(ctx, pk)

    def fn(c0_0, c0_1, c1_0, c1_1):
        out = mult_relin(ctx, pk, sk, noise, k, c0_0, c0_1, c1_0, c1_1)
        parts = dict((h.powS, d) for h, d in out.parts)
        return parts[0], parts[1]

    qs = ctx.primes_of(k, False)
    rng = np.random.default_rng(0)
    ex = tuple(to_device(rng.integers(0, qs[:, None].astype(np.int64),
                                      (k, ctx.n_eval)).astype(np.uint32),
                         ctx.device)
               for _ in range(4))
    return fn, ex


def make_batched_mult_relin(ctx: Context, sk: SecKey, batch: int,
                            k: int | None = None):
    """Batched version: the same fn on [batch, k, N] part tensors; the
    example arguments are the unbatched ones repeated `batch` times."""
    fn, ex = make_mult_relin(ctx, sk, k)
    bex = tuple(e.unsqueeze(0).repeat(batch, 1, 1) for e in ex)
    return fn, bex


def fresh_noise(ctx: Context, pk) -> float:
    """Noise bound of a fresh public-key encryption."""
    pr = ctx.ptxt_space
    noise = ctx.noise_small(0.5) + pk.enc_noise
    e_b = math.log2(max(pr, 1)) + ctx.noise_gaussian()
    noise = log2_add(noise, e_b)
    noise = log2_add(noise, e_b + pk.sk_bound)
    return log2_add(noise, ctx.noise_mod(pr))
