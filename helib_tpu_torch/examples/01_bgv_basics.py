"""Tutorial 1 on the PyTorch port: BGV basics -- packed arithmetic,
rotations, depth (the twin of examples/01_bgv_basics.py).

    python helib_tpu_torch/examples/01_bgv_basics.py [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np

from helib_tpu_torch.context import Context
from helib_tpu_torch.keys import SecKey, PubKey
from helib_tpu_torch.ea import EncryptedArray
from helib_tpu_torch.algos.sums import total_sums


def main(device="cuda"):
    # Build a context: m=31 gives 6 slots of GF(2^5) with p=2.
    ctx = Context(m=31, p=2, r=1, bits=400, c=3, scheme="bgv", device=device)
    ctx.printout()
    sk = SecKey(ctx, seed=0)
    pk = PubKey(sk)
    ea = EncryptedArray(ctx)
    rng = np.random.default_rng(0)

    v1 = np.array([1, 0, 1, 1, 0, 1])
    v2 = np.array([0, 1, 1, 0, 1, 1])
    c1 = ea.encrypt(list(v1), pk, rng)
    c2 = ea.encrypt(list(v2), pk, rng)
    print("capacity after encrypt:", round(c1.capacity(), 1))

    prod = c1.multiply(c2, sk)               # slot-wise product, relinearized
    got = ea.decrypt_ints(prod, sk)
    print("product slots:", got, "== ", v1 * v2)
    assert np.array_equal(got, v1 * v2), "product"
    print("capacity after multiply:", round(prod.capacity(), 1))

    rot = ea.rotate(prod.copy(), 2, sk)
    got = ea.decrypt_ints(rot, sk)
    print("rotated by 2:", got)
    assert np.array_equal(got, np.roll(v1 * v2, 2)), "rotate"

    tot = total_sums(ea, prod, sk)
    got = ea.decrypt_ints(tot, sk)
    print("total sums:", got)
    assert np.array_equal(got, np.full(len(v1), np.sum(v1 * v2) % 2)), \
        "total sums"


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
