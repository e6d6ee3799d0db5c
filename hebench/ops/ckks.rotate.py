"""CKKS slot rotation by amt (`EncryptedArrayCKKS.rotate`), amt one of the
configuration's `rotations`."""

import numpy as np

WARM = "amt"


def run(sch, a, b, const, amt):
    return sch.ea.rotate(a.copy(), amt, sch.pk)


def expected(cfg, it):
    return np.roll(np.asarray(it["a"]), it["amt"])
