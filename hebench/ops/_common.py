"""What the operations' files share (no operation of its own)."""

from __future__ import annotations

import math
from fractions import Fraction

from hebench.reference.numbth import prime_chain


def plaintext_modulus(cfg: dict) -> int:
    return cfg["p"] ** cfg["r"]


def ctxt_primes(cfg: dict) -> list:
    return prime_chain(cfg["m"], cfg["bits"], cfg["c"], cfg["scheme"],
                       cfg["p"])[0]


def batched_mult_relin(sch, batch: int):
    """The batched product with relinearization of the program's pipeline
    (`pipeline.make_batched_mult_relin`) on `batch` ciphertexts."""
    from helib_tpu_torch.pipeline import make_batched_mult_relin
    fn, _ = make_batched_mult_relin(sch.ctx, sch.sk, batch)
    return fn


def product_out(cfg: dict, c0, c1) -> dict:
    """What the batched product of two fresh top-level ciphertexts is, as
    `port.host_parts` describes a Ctxt: on the ciphertext primes, special
    primes dropped; under CKKS at the square of the fresh scale 2^r, under
    BGV with the plaintext factor Q mod p^r of the tensor product (Q the
    product of the ciphertext primes, worked out by the reference)."""
    qs = ctxt_primes(cfg)
    out = {"c0": c0, "c1": c1, "k": len(qs), "special": False,
           "canonical": True, "scale": None, "int_factor": 1}
    if cfg["scheme"] == "ckks":
        out["scale"] = Fraction(1 << cfg["r"]) ** 2
    else:
        out["int_factor"] = math.prod(qs) % plaintext_modulus(cfg)
    return out
