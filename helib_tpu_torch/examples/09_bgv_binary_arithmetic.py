"""Tutorial 9 on the PyTorch port: binary arithmetic -- integers encrypted
bit by bit (one ciphertext a bit, each bit packed across the slots), added,
multiplied and compared by HElib's circuits (the twin of
examples/09_bgv_binary_arithmetic.py, after HElib's
examples/BGV_binary_arithmetic).

    python helib_tpu_torch/examples/09_bgv_binary_arithmetic.py [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np

from helib_tpu_torch.context import Context
from helib_tpu_torch.keys import SecKey, PubKey
from helib_tpu_torch.ea import EncryptedArray
from helib_tpu_torch.algos.binary import (add_two_numbers, mult_two_numbers,
                                          compare_two_numbers)


def enc_number(ea, pk, rng, value: int, bits: int):
    """bit i of `value` replicated across slots, one ctxt per bit."""
    return [ea.encrypt([(value >> i) & 1] * ea.nslots, pk, rng)
            for i in range(bits)]


def dec_number(ea, sk, ct_bits) -> int:
    return sum(int(ea.decrypt_ints(b, sk)[0]) << i
               for i, b in enumerate(ct_bits))


def main(device="cuda"):
    ctx = Context(m=31, p=2, r=1, bits=500, c=3, scheme="bgv", device=device)
    sk = SecKey(ctx, seed=0)
    pk = PubKey(sk)
    ea = EncryptedArray(ctx)
    rng = np.random.default_rng(6)

    a, b = 11, 6
    ea_bits = 4
    ca = enc_number(ea, pk, rng, a, ea_bits)
    cb = enc_number(ea, pk, rng, b, ea_bits)

    s = add_two_numbers(ea, ca, cb, sk)
    print(f"{a} + {b} = {dec_number(ea, sk, s)}")
    assert dec_number(ea, sk, s) == a + b

    p = mult_two_numbers(ea, ca, cb, sk)
    print(f"{a} * {b} = {dec_number(ea, sk, p)}")
    assert dec_number(ea, sk, p) == a * b

    mu, ni = compare_two_numbers(ea, ca, cb, sk)
    gt = int(ea.decrypt_ints(mu, sk)[0])
    lt = int(ea.decrypt_ints(ni, sk)[0])
    print(f"compare: a>b={gt} a<b={lt}")
    assert (gt, lt) == (1, 0)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
