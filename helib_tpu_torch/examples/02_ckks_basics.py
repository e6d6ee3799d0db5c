"""Tutorial 2 on the PyTorch port: CKKS approximate arithmetic -- encode,
multiply, rescale (the twin of examples/02_ckks_basics.py).

    python helib_tpu_torch/examples/02_ckks_basics.py [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np

from helib_tpu_torch.context import Context
from helib_tpu_torch.keys import SecKey, PubKey
from helib_tpu_torch.ckks import EncryptedArrayCKKS

TOL = 1e-2      # the example states none; the CKKS tests' decrypt bound


def main(device="cuda"):
    ctx = Context(m=256, p=-1, r=30, bits=240, c=3, scheme="ckks",
                  device=device)
    sk = SecKey(ctx, seed=0)
    pk = PubKey(sk)
    ea = EncryptedArrayCKKS(ctx)
    rng = np.random.default_rng(0)

    z = rng.uniform(-1, 1, ea.nslots) + 1j * rng.uniform(-1, 1, ea.nslots)
    ct = ea.encrypt(z, pk, rng)
    sq = ct.square(sk)
    ea.rescale(sq)
    got = ea.decrypt(sq, sk)
    err = float(np.max(np.abs(got - z * z)))
    print("max error of z^2:", err)
    assert err < TOL, "z^2"
    rot = ea.rotate(sq, 1, sk)
    err = float(np.max(np.abs(ea.decrypt(rot, sk) - np.roll(z * z, 1))))
    print("rotate ok:", err)
    assert err < TOL, "rotate"


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
