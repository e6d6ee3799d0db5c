"""Tutorial 3 on the PyTorch port: thin bootstrapping -- refresh a
ciphertext whose capacity is nearly spent (the twin of
examples/03_thin_bootstrap.py).

    python helib_tpu_torch/examples/03_thin_bootstrap.py [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np

from helib_tpu_torch.context import Context
from helib_tpu_torch.keys import SecKey, PubKey
from helib_tpu_torch.ea import EncryptedArray
from helib_tpu_torch.recryption import RecryptData, thin_recrypt


def main(device="cuda"):
    ctx = Context(m=31, p=2, r=1, bits=800, c=3, scheme="bgv", device=device)
    sk = SecKey(ctx, seed=0, hwt=16)      # sparse key for bootstrapping
    pk = PubKey(sk)
    ea = EncryptedArray(ctx)
    rc = RecryptData(ctx, sk, ea, hwt=16)
    print("recryption params:", rc)
    rng = np.random.default_rng(0)

    v = np.array([1, 0, 1, 1, 0, 1])
    ct = ea.encrypt(list(v), pk, rng)
    ct.bring_to_k(3)                      # pretend we computed a deep circuit
    print("capacity before recrypt:", round(ct.capacity(), 1))
    out = thin_recrypt(ct, rc, sk)
    print("capacity after recrypt:", round(out.capacity(), 1))
    assert out.capacity() > ct.capacity(), "capacity not restored"
    got = ea.decrypt_ints(out, sk)
    print("slots preserved:", got, "==", v)
    assert np.array_equal(got, v), "slots"


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
