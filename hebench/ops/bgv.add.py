"""BGV sum of two ciphertexts (`Ctxt.add`)."""

from hebench.ops._common import plaintext_modulus
from hebench.reference import schemes

WARM = None


def run(sch, a, b, const, amt):
    return a.copy().add(b)


def expected(cfg, it):
    return schemes.bgv_add(it["a"], it["b"], cfg["m"], plaintext_modulus(cfg))
