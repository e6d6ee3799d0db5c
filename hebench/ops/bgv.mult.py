"""BGV product of two ciphertexts with relinearization: `Ctxt.multiply`
one at a time, `pipeline.make_batched_mult_relin` in a batch."""

from hebench import counts
from hebench.ops._common import (batched_mult_relin, plaintext_modulus,
                                 product_out)
from hebench.reference import schemes

WARM = None
batched = batched_mult_relin
batched_out = product_out
transforms = counts.transforms


def run(sch, a, b, const, amt):
    return a.multiply(b, sch.pk)


def expected(cfg, it):
    return schemes.bgv_mul(it["a"], it["b"], cfg["m"], plaintext_modulus(cfg))
