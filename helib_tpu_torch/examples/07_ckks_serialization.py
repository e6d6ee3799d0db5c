"""Tutorial 7 on the PyTorch port: serialization -- the client ships the
context, the public key (with its key-switching matrices) and a
ciphertext; the server computes without any secret; the client decrypts
the result (the twin of examples/07_ckks_serialization.py, after HElib's
tutorials 07_ckks_serialization.cpp and 08_ckks_deserialization.cpp).

    python helib_tpu_torch/examples/07_ckks_serialization.py [--device cpu]
"""

import argparse
import io
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import numpy as np

from helib_tpu_torch.context import Context
from helib_tpu_torch.keys import SecKey, PubKey, SKHandle
from helib_tpu_torch.ckks import EncryptedArrayCKKS
from helib_tpu_torch.io import (write_context, read_context, write_pubkey,
                                read_pubkey, write_ctxt, read_ctxt)

TOL = 1e-2      # the example states none; the CKKS tests' decrypt bound


def main(device="cuda"):
    # ---- client side ----
    ctx = Context(m=256, p=-1, r=30, bits=240, c=3, scheme="ckks",
                  device=device)
    sk = SecKey(ctx, seed=0)
    pk = PubKey(sk)
    sk.gen_ks_matrix(SKHandle(2, 1, 0))     # mult relin matrix
    ea = EncryptedArrayCKKS(ctx)
    rng = np.random.default_rng(4)
    z = rng.uniform(-1, 1, ea.nslots)
    ct = ea.encrypt(z, pk, rng)

    blob = io.BytesIO()
    write_context(blob, ctx)
    write_pubkey(blob, pk)                  # includes the KS matrices
    write_ctxt(blob, ct)
    print(f"serialized context+pubkey+ctxt: {blob.tell()} bytes")

    # ---- server side: NO SecKey object exists here ----
    blob.seek(0)
    sctx = read_context(blob, device=device)
    spk = read_pubkey(blob, sctx)
    sct = read_ctxt(blob, sctx, spk)
    result = sct.multiply(sct, spk)         # sk-free relinearization
    out = io.BytesIO()
    write_ctxt(out, result)

    # ---- client side again ----
    out.seek(0)
    back = read_ctxt(out, ctx, pk)
    sea = EncryptedArrayCKKS(ctx)
    err = np.max(np.abs(sea.decrypt(back, sk) - z * z))
    print(f"server-computed z^2: err={float(err):.2e}")
    assert err < TOL, "server-computed z^2"


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
