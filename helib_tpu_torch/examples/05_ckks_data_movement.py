"""Tutorial 5 on the PyTorch port: CKKS data movement -- rotations and
shifts across the slot vector, complex conjugation and real/imaginary
extraction (the twin of examples/05_ckks_data_movement.py, after HElib's
tutorials 03_ckks_data_movement.cpp and 06_ckks_complex.cpp).

    python helib_tpu_torch/examples/05_ckks_data_movement.py [--device cpu]
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
    rng = np.random.default_rng(2)

    z = rng.uniform(-1, 1, ea.nslots) + 1j * rng.uniform(-1, 1, ea.nslots)
    ct = ea.encrypt(z, pk, rng)

    rot = ea.rotate(ct.copy(), 3, sk)           # cyclic: slot i -> i+3
    err = np.max(np.abs(ea.decrypt(rot, sk) - np.roll(z, 3)))
    print(f"rotate(3):  err={float(err):.2e}")
    assert err < TOL, "rotate"

    sh = ea.shift(ct.copy(), 2, sk)             # non-cyclic: zeros shift in
    exp = np.concatenate([[0, 0], z[:-2]])
    err = np.max(np.abs(ea.decrypt(sh, sk) - exp))
    print(f"shift(2):   err={float(err):.2e}")
    assert err < TOL, "shift"

    cj = ct.copy().conjugate(sk)
    err = np.max(np.abs(ea.decrypt(cj, sk) - np.conj(z)))
    print(f"conjugate:  err={float(err):.2e}")
    assert err < TOL, "conjugate"

    re = ea.extract_real_part(ct.copy(), sk)
    im = ea.extract_imaginary_part(ct.copy(), sk)
    err_r = np.max(np.abs(ea.decrypt(re, sk) - z.real))
    err_i = np.max(np.abs(ea.decrypt(im, sk) - z.imag))
    print(f"re/im:      err={float(err_r):.2e} / {float(err_i):.2e}")
    assert max(err_r, err_i) < TOL, "real/imaginary parts"


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
