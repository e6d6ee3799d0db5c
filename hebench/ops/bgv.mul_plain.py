"""BGV product of a ciphertext and a plaintext polynomial
(`Ctxt.mul_constant_poly`)."""

from hebench.ops._common import plaintext_modulus
from hebench.reference import schemes

WARM = "const"


def run(sch, a, b, const, amt):
    out = a.copy()
    out.mul_constant_poly(const)
    return out


def expected(cfg, it):
    return schemes.bgv_mul(it["a"], it["const"], cfg["m"],
                           plaintext_modulus(cfg))
