"""Ciphertext pipelines (helib_tpu.pipeline).

The hot sequences of every BGV/CKKS circuit as callables on part tensors:
multiply (tensor product, digit decomposition, key-switch MAC, mod-down),
rotate (automorphism, key switch, mod-down) and public-key encryption with
on-device sampling.  PyTorch runs them eagerly; batching is the leading dims
that every ring op broadcasts over, so the batched pipeline is the same
function on [batch, k, N] tensors.
"""

from __future__ import annotations

import math

import numpy as np

import torch

from .context import Context, log2_add
from .keys import SecKey, PubKey, SKHandle
from .ctxt import Ctxt
from .dcrt import (rt_add, rt_mul, sample_small_rt_dev,
                   sample_gaussian_rt_dev)
from .ops.modops import to_device


def random_parts(ctx: Context, k: int, count: int) -> tuple:
    """`count` uniform [k, N] residue tensors from np.random.default_rng(0),
    the example arguments helib_tpu's pipelines return."""
    qs = ctx.primes_of(k, False)
    rng = np.random.default_rng(0)
    return tuple(to_device(rng.integers(0, qs[:, None].astype(np.int64),
                                        (k, ctx.n_eval)).astype(np.uint32),
                           ctx.device)
                 for _ in range(count))


def mult_relin(ctx: Context, pk: PubKey, key, noise: float, k: int,
               c0_0, c0_1, c1_0, c1_1, shard=None) -> Ctxt:
    """The relinearized product of two canonical ciphertexts at level k
    (given as their part tensors), special primes dropped.  The mod-switch
    noise is not measured (no host round trip), as in helib_tpu's traced
    pipeline, so the result's noise equals the jitted reference's.
    `shard` (parallel/mesh.py LimbShard): the parts hold one rank's rows."""
    pr = ctx.ptxt_space if ctx.scheme == "bgv" else 1

    def mk(a, b):
        return Ctxt(ctx, pk, [(SKHandle(0, 1, 0), a), (SKHandle(1, 1, 0), b)],
                    k, False, pr, noise, 1, shard=shard)
    out = mk(c0_0, c0_1).tensor(mk(c1_0, c1_1))
    out.relinearize(key)
    out.drop_special_primes(measure=False)
    return out


def make_mult_relin(ctx: Context, sk: SecKey, k: int | None = None,
                    noise: float | None = None, shard=None):
    """Returns (fn, example_args): fn maps the four part tensors of two
    canonical ciphertexts at level k to the two part tensors of their
    relinearized product (with special primes dropped).  With a `shard`,
    fn takes and returns one rank's rows of each (the example arguments
    stay whole)."""
    k = k if k is not None else ctx.L
    pk = sk.pubkey or PubKey(sk)
    sk.gen_ks_matrix(SKHandle(2, 1, 0))
    # inputs carry a real fresh-encryption noise bound (see fresh_noise)
    noise = noise if noise is not None else fresh_noise(ctx, pk)

    def fn(c0_0, c0_1, c1_0, c1_1):
        out = mult_relin(ctx, pk, sk, noise, k, c0_0, c0_1, c1_0, c1_1,
                         shard)
        parts = dict((h.powS, d) for h, d in out.parts)
        return parts[0], parts[1]

    return fn, random_parts(ctx, k, 4)


def make_batched_mult_relin(ctx: Context, sk: SecKey, batch: int,
                            k: int | None = None, shard=None):
    """Batched version: the same fn on [batch, k, N] part tensors; the
    example arguments are the unbatched ones repeated `batch` times."""
    fn, ex = make_mult_relin(ctx, sk, k, shard=shard)
    bex = tuple(e.unsqueeze(0).repeat(batch, 1, 1) for e in ex)
    return fn, bex


def make_automorph_relin(ctx: Context, sk: SecKey, kexp: int | None = None,
                         k: int | None = None, shard=None):
    """Returns (fn, example_args): fn maps the two part tensors of a
    canonical ciphertext at level k to those of its rotation X -> X^kexp,
    key-switched back to the base key, special primes dropped (HElib's
    smartAutomorph with an exact matrix).  kexp defaults to the first
    hypercube generator, or 3 where there is none.  `shard`: as in
    make_mult_relin."""
    k = k if k is not None else ctx.L
    pk = sk.pubkey or PubKey(sk)
    if kexp is None:
        kexp = ctx.pal.gens[0] if ctx.pal.gens else 3
    kexp %= 2 * ctx.n_eval if ctx.pal.pow2 else ctx.m
    sk.gen_ks_matrix(SKHandle(1, kexp, 0))
    noise = fresh_noise(ctx, pk)
    pr = ctx.ptxt_space if ctx.scheme == "bgv" else 1

    def fn(c0, c1):
        ct = Ctxt(ctx, pk, [(SKHandle(0, 1, 0), c0), (SKHandle(1, 1, 0), c1)],
                  k, False, pr, noise, 1, shard=shard)
        ct.automorph(kexp)
        ct.relinearize(sk)
        ct.drop_special_primes(measure=False)
        parts = dict((h.powS, d) for h, d in ct.parts)
        return parts[0], parts[1]

    return fn, random_parts(ctx, k, 2)


def make_encrypt(ctx: Context, pk: PubKey):
    """Public-key encryption with on-device sampling: fn(generator,
    pt_eval) -> the two part tensors, pt_eval the plaintext's [L, N]
    residues in the eval domain, `generator` a torch.Generator on
    ctx.device.  r, e0 and e1 are drawn from it in that order, so one seed
    gives one ciphertext; its bits differ from helib_tpu's jax.random keys,
    its distribution does not."""
    k, special = ctx.L, False
    pr = ctx.ptxt_space if ctx.scheme == "bgv" else 1
    b, a = (d for _, d in pk.enc_key)

    def fn(generator: torch.Generator, pt_eval):
        r, _ = sample_small_rt_dev(ctx, generator, k, special)
        e0, _ = sample_gaussian_rt_dev(ctx, generator, k, special, mult=pr)
        e1, _ = sample_gaussian_rt_dev(ctx, generator, k, special, mult=pr)
        c0 = rt_add(ctx, rt_mul(ctx, b, r, k, special), e0, k, special)
        c1 = rt_add(ctx, rt_mul(ctx, a, r, k, special), e1, k, special)
        return rt_add(ctx, c0, pt_eval, k, special), c1

    return fn


def fresh_noise(ctx: Context, pk) -> float:
    """Noise bound of a fresh public-key encryption, make_encrypt's
    distribution (BGV adds the plaintext's mod-p^r term)."""
    pr = ctx.ptxt_space if ctx.scheme == "bgv" else 1
    noise = ctx.noise_small(0.5) + pk.enc_noise
    e_b = math.log2(max(pr, 1)) + ctx.noise_gaussian()
    noise = log2_add(noise, e_b)
    noise = log2_add(noise, e_b + pk.sk_bound)
    if ctx.scheme == "bgv":
        noise = log2_add(noise, ctx.noise_mod(pr))
    return noise
