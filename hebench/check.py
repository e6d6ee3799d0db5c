"""Whether what the timed window produced is right, by the plain reference.

Each judged item is an output the window produced (its two parts on the
host, its prime set and, under CKKS its scale, under BGV its plaintext
factor), the operation and the
inputs the harness made for it.  The reference decrypts the output with
the secret key the harness drew and compares it with the operation done on
the plaintexts, as the operation's file (hebench/ops/) gives it: BGV
exactly (coefficients mod p^r that differ, once the plaintext factor the
output states is divided out), CKKS by the largest slot error.  Every
residue must also lie below its prime.  The numbers compared and their
limits are returned; nothing of the program is called here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import cells
from .reference import ring, schemes
from .reference.numbth import prime_chain

CHUNK = 8          # outputs decrypted together


def _primes(cfg: dict, out: dict, chain) -> tuple:
    qs, sp = chain
    return tuple(qs[:out["k"]]) + (tuple(sp) if out["special"] else ())


def _residues(t) -> np.ndarray:
    """A part's residues as int64, read as the unsigned 32-bit values the
    program stores."""
    return np.ascontiguousarray(t.numpy()).view(np.uint32).astype(np.int64)


def _bad_residues(parts: list, primes: tuple) -> int:
    q = np.array(primes, dtype=np.int64)[:, None]
    return int(sum(np.count_nonzero(p >= q) for p in parts))


def _inverse(x: int, pr: int) -> int:
    """x^-1 mod pr, 0 where a wrong factor has none."""
    try:
        return pow(x, -1, pr)
    except ValueError:
        return 0


def _groups(items: list, primes_of) -> dict:
    """Items by prime set, so outputs on one set decrypt together."""
    out: dict = {}
    for it in items:
        out.setdefault(primes_of(it), []).append(it)
    return out


def judge(cfg: dict, s_coeffs, items: list) -> dict:
    """{number: value} over the judged items; an item that never came (its
    output None) or is not a canonical ciphertext counts as all wrong."""
    chain = prime_chain(cfg["m"], cfg["bits"], cfg["c"], cfg["scheme"],
                        cfg["p"])
    sk = ring.SecretKey(s_coeffs, cfg["m"])
    bgv = cfg["scheme"] == "bgv"
    m, pr = cfg["m"], cfg["p"] ** cfg["r"]
    expected = lambda it: cells.op(cfg["scheme"], it["op"]).expected(cfg, it)
    bad, wrong, err = 0, 0, 0.0
    good = [it for it in items if it["out"] is not None
            and it["out"]["canonical"]]
    lost = len(items) - len(good)
    if bgv:
        wrong += lost * (len(schemes.phi_poly(m)) - 1)
    elif lost:
        err = math.inf
    groups = _groups(good, lambda it: _primes(cfg, it["out"], chain))
    for primes, group in groups.items():
        for s in range(0, len(group), CHUNK):
            chunk = group[s:s + CHUNK]
            c0, c1 = (np.stack([_residues(it["out"][c]) for it in chunk])
                      for c in ("c0", "c1"))
            bad += _bad_residues([c0, c1], primes)
            c0, c1 = torch.from_numpy(c0), torch.from_numpy(c1)
            d = ring.decrypt_digits(c0, c1, sk, primes)
            if bgv:
                got = schemes.reduce_phim(ring.digits_mod(d, primes, pr), m,
                                          pr)
                # decryption gives the plaintext times (Q mod p^r) *
                # intFactor, Q the product of the output's primes
                q_mod = math.prod(primes) % pr
                inv = torch.tensor([_inverse(q_mod * it["out"]["int_factor"],
                                             pr) for it in chunk])
                got = got * inv[:, None] % pr
                want = torch.stack([expected(it) for it in chunk])
                wrong += int((got != want).sum())
            else:
                x = ring.digits_float(d, primes)
                scale = torch.tensor([float(it["out"]["scale"])
                                      for it in chunk], dtype=torch.float64)
                z = schemes.ckks_decode(x / scale[:, None], m).numpy()
                want = np.stack([expected(it) for it in chunk])
                e = np.abs(z - want)
                err = max(err, float(np.max(e)) if np.all(np.isfinite(e))
                          else math.inf)
    if bgv:
        return {"wrong_coeffs": wrong, "bad_residues": bad}
    return {"max_err": err, "bad_residues": bad}


def compare(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    table = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
