"""Tutorial 6 on the PyTorch port: a plaintext matrix times an encrypted
vector (MatMulCKKS, rotations and diagonals) and deferred
relinearization (the twin of examples/06_ckks_matmul.py, after HElib's
tutorials 04_ckks_matmul.cpp and 05_ckks_multlowlvl.cpp).

    python helib_tpu_torch/examples/06_ckks_matmul.py [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np

from helib_tpu_torch.context import Context
from helib_tpu_torch.keys import SecKey, PubKey
from helib_tpu_torch.ckks import EncryptedArrayCKKS
from helib_tpu_torch.algos.matmul_ckks import MatMulCKKS

TOL = 1e-2      # the example states none; the CKKS tests' decrypt bound


def main(device="cuda"):
    ctx = Context(m=256, p=-1, r=30, bits=300, c=3, scheme="ckks",
                  device=device)
    sk = SecKey(ctx, seed=0)
    pk = PubKey(sk)
    ea = EncryptedArrayCKKS(ctx)
    rng = np.random.default_rng(3)
    n = ea.nslots

    M = rng.uniform(-1, 1, (n, n))
    z = rng.uniform(-1, 1, n)
    ct = ea.encrypt(z, pk, rng)
    mm = MatMulCKKS(ea, lambda i, j: M[i, j])
    out = mm.apply(ct, sk)
    err = np.max(np.abs(ea.decrypt(out, sk).real - M @ z))
    print(f"matmul {n}x{n}: err={float(err):.2e}")
    assert err < TOL, "matmul"

    # deferred relinearization (HElib's 05_ckks_multlowlvl.cpp): an inner
    # product sum_i c_i * d_i adds the unrelinearized products and
    # relinearizes once at the end
    ws = rng.uniform(-1, 1, (3, n))
    cs = [ea.encrypt(w, pk, rng) for w in ws]
    ds = [ea.encrypt(z, pk, rng) for _ in range(3)]
    acc = None
    for c, d in zip(cs, ds):
        t = c.mul_low_level(d)          # fast: tensor only, 3 parts
        acc = t if acc is None else acc.add(t)
    acc.relinearize(sk)                 # one relin for the whole sum
    ea.rescale(acc)
    expect = sum(w * z for w in ws)
    err = np.max(np.abs(ea.decrypt(acc, sk).real - expect))
    print(f"inner product (1 relin for 3 mults): err={float(err):.2e} "
          f"capacity={acc.capacity():.1f}")
    assert err < TOL, "inner product"


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
