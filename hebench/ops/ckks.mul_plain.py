"""CKKS product of a ciphertext and real slots encoded on the host
(`EncryptedArrayCKKS.mul_const`), then rescaled."""

import numpy as np

WARM = "const"


def run(sch, a, b, const, amt):
    return sch.ea.rescale(sch.ea.mul_const(a, const))


def expected(cfg, it):
    return np.asarray(it["a"]) * np.asarray(it["const"])
