"""CKKS product of two ciphertexts with relinearization, then rescaled
(`Ctxt.multiply`, `EncryptedArrayCKKS.rescale`) one at a time;
`pipeline.make_batched_mult_relin` (not rescaled) in a batch."""

import numpy as np

from hebench import counts
from hebench.ops._common import batched_mult_relin, product_out

WARM = None
batched = batched_mult_relin
batched_out = product_out
transforms = counts.transforms


def run(sch, a, b, const, amt):
    return sch.ea.rescale(a.multiply(b, sch.pk))


def expected(cfg, it):
    return np.asarray(it["a"]) * np.asarray(it["b"])
