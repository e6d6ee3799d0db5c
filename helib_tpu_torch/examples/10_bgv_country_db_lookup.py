"""Tutorial 10 on the PyTorch port: a private database lookup -- a small
key-value table encrypted column-wise (one record a slot); the client sends
an encrypted key, the server computes an encrypted match mask and selects
the value without seeing either (the twin of
examples/10_bgv_country_db_lookup.py, after HElib's
examples/BGV_country_db_lookup).

    python helib_tpu_torch/examples/10_bgv_country_db_lookup.py [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np

from helib_tpu_torch.context import Context
from helib_tpu_torch.keys import SecKey, PubKey
from helib_tpu_torch.ea import EncryptedArray
from helib_tpu_torch.algos.query import Database, make_query
from helib_tpu_torch.algos.sums import total_sums

COUNTRIES = ["norway", "chile", "ghana", "nepal"]
CAPITALS = ["oslo", "santiago", "accra", "kathmandu"]


def main(device="cuda"):
    # p=131, m=127: 18 slots of byte codes (d=7)
    ctx = Context(m=127, p=131, r=1, bits=800, c=3, scheme="bgv",
                  device=device)
    sk = SecKey(ctx, seed=0)
    pk = PubKey(sk)
    ea = EncryptedArray(ctx)
    rng = np.random.default_rng(7)
    n = len(COUNTRIES)
    assert ea.nslots >= n

    def code(s):
        return sum(ord(c) for c in s) % ctx.ptxt_space

    keys = [code(c) for c in COUNTRIES] + [0] * (ea.nslots - n)
    vals = [code(c) for c in CAPITALS] + [0] * (ea.nslots - n)
    db = Database(ea, sk, [ea.encrypt(keys, pk, rng)])
    ct_vals = ea.encrypt(vals, pk, rng)

    lookup = "ghana"
    q = ea.encrypt([code(lookup)] * ea.nslots, pk, rng)

    # server: match mask (1 in the matching record's slot), then select
    mask = db.contains(make_query(0), {0: q})
    sel = ct_vals.multiply(mask, sk)
    answer = total_sums(ea, sel, sk)          # replicate answer to all slots

    got = int(ea.decrypt_ints(answer, sk)[0])
    expect = code(CAPITALS[COUNTRIES.index(lookup)])
    print(f"query={lookup!r} -> capital code {got} "
          f"(expect {expect}) {'✓' if got == expect else '✗'}")
    assert got == expect


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
