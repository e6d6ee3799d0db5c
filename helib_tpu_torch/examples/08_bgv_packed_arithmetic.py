"""Tutorial 8 on the PyTorch port: packed BGV arithmetic -- one ciphertext
holds nslots values; adds, multiplies and rotations act slot-wise and
plaintext operands mix in (the twin of examples/08_bgv_packed_arithmetic.py,
after HElib's examples/BGV_packed_arithmetic).

    python helib_tpu_torch/examples/08_bgv_packed_arithmetic.py [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np

from helib_tpu_torch.context import Context
from helib_tpu_torch.keys import SecKey, PubKey
from helib_tpu_torch.ea import EncryptedArray
from helib_tpu_torch.ptxt import PtxtBGV


def main(device="cuda"):
    # HElib's example runs m=32109, p=4999 for many slots; a quick demo
    # ring with the same calls
    ctx = Context(m=257, p=2, r=4, bits=300, c=2, scheme="bgv", device=device)
    sk = SecKey(ctx, seed=0)
    pk = PubKey(sk)
    ea = EncryptedArray(ctx)
    rng = np.random.default_rng(5)
    pr = ctx.ptxt_space
    print(f"m={ctx.m} p^r={pr} slots={ea.nslots} d={ea.d}")

    v = rng.integers(0, pr, ea.nslots)
    ct = ea.encrypt(list(v), pk, rng)

    ct.add(ct)                               # ctxt + ctxt
    expect = (v + v) % pr
    ct2 = ct.multiply(ct, sk)                # ctxt * ctxt (+relin)
    expect = expect * expect % pr

    pt = PtxtBGV(ea, list(rng.integers(0, pr, ea.nslots)))
    ct2.add_constant(ea.encode_ptxt(pt.ints()))   # ctxt + ptxt
    expect = (expect + pt.ints()) % pr

    rot = ea.rotate(ct2, 1, sk)              # SIMD rotation
    expect = np.roll(expect, 1)

    got = ea.decrypt_ints(rot, sk)
    assert np.array_equal(got, expect)
    print("packed add/mult/ptxt-add/rotate: exact ✓  "
          f"capacity={rot.capacity():.0f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
