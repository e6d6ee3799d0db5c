"""Command-line utilities: create-context / key-gen / encrypt / decrypt
(helib_tpu.cli).

Role of HElib's utils/ (create-context/create-context.cpp,
key-gen/key-gen.cpp, crypto/{encrypt,decrypt}.cpp), with helib_tpu's
arguments and files.  Every command runs on `device` (default cuda) and
fails when that device does not exist: pass device=cpu to run on the host.

Usage:
  python -m helib_tpu_torch.cli create-context m=45 p=2 r=1 bits=300 c=3 out=ctx.bin
  python -m helib_tpu_torch.cli key-gen ctx=ctx.bin out=key
  python -m helib_tpu_torch.cli encrypt ctx=ctx.bin key=key.pk in=data.txt out=ct.bin
  python -m helib_tpu_torch.cli decrypt ctx=ctx.bin key=key.sk in=ct.bin out=data.txt
"""

from __future__ import annotations

import sys

import numpy as np

from .argmap import ArgMap
from .context import Context
from .keys import SecKey, PubKey
from .ea import EncryptedArray
from . import io as hio


def _args(am: ArgMap, argv) -> dict:
    return am.arg("device", "cuda").parse(argv)


def cmd_create_context(argv):
    args = _args(ArgMap().arg("m", 45).arg("p", 2).arg("r", 1).arg("bits", 300)
                 .arg("c", 3).arg("scheme", "bgv").arg("out", "ctx.bin")
                 .toggle("info"), argv)
    out = args.pop("out")
    info = args.pop("info")
    ctx = Context(**args)
    with open(out, "wb") as f:
        hio.write_context(f, ctx)
    if info:
        print(ctx)
    print(f"wrote context to {out}")


def _load_ctx(path, device):
    with open(path, "rb") as f:
        return hio.read_context(f, device=device)


def cmd_key_gen(argv):
    args = _args(ArgMap().arg("ctx", "ctx.bin").arg("out", "key")
                 .arg("seed", 0), argv)
    ctx = _load_ctx(args["ctx"], args["device"])
    sk = SecKey(ctx, seed=args["seed"])
    pk = PubKey(sk)
    with open(args["out"] + ".sk", "wb") as f:
        hio.write_seckey(f, sk)
    with open(args["out"] + ".pk", "wb") as f:
        hio.write_pubkey(f, pk)
    print(f"wrote {args['out']}.sk / {args['out']}.pk")


def cmd_encrypt(argv):
    args = _args(ArgMap().arg("ctx", "ctx.bin").arg("key", "key.pk")
                 .arg("in", "data.txt").arg("out", "ct.bin")
                 .arg("seed", 1), argv)
    ctx = _load_ctx(args["ctx"], args["device"])
    with open(args["key"], "rb") as f:
        pk = hio.read_pubkey(f, ctx)
    ea = EncryptedArray(ctx)
    vals = np.loadtxt(args["in"], dtype=np.int64, ndmin=1)
    rng = np.random.default_rng(args["seed"])
    ct = ea.encrypt(list(vals), pk, rng)
    with open(args["out"], "wb") as f:
        hio.write_ctxt(f, ct)
    print(f"encrypted {len(vals)} values -> {args['out']}")


def cmd_decrypt(argv):
    args = _args(ArgMap().arg("ctx", "ctx.bin").arg("key", "key.sk")
                 .arg("in", "ct.bin").arg("out", "data.txt"), argv)
    ctx = _load_ctx(args["ctx"], args["device"])
    with open(args["key"], "rb") as f:
        sk = hio.read_seckey(f, ctx)
    pk = PubKey(sk)     # needed only as ctxt holder
    ea = EncryptedArray(ctx)
    with open(args["in"], "rb") as f:
        ct = hio.read_ctxt(f, ctx, pk)
    vals = ea.decrypt_ints(ct, sk)
    np.savetxt(args["out"], vals, fmt="%d")
    print(f"decrypted -> {args['out']}")


COMMANDS = {"create-context": cmd_create_context, "key-gen": cmd_key_gen,
            "encrypt": cmd_encrypt, "decrypt": cmd_decrypt}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m helib_tpu_torch.cli {{{'|'.join(COMMANDS)}}} "
              f"[args...] [device=cuda|cpu]", file=sys.stderr)
        raise SystemExit(1)
    COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
