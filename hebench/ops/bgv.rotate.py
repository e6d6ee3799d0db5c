"""BGV automorphism X -> X^amt with key switching (`Ctxt.smart_automorph`),
amt one of the configuration's `rotations`."""

from hebench.ops._common import plaintext_modulus
from hebench.reference import schemes

WARM = "amt"


def run(sch, a, b, const, amt):
    return a.copy().smart_automorph(amt, sch.pk)


def expected(cfg, it):
    return schemes.bgv_automorph(it["a"], it["amt"], cfg["m"],
                                 plaintext_modulus(cfg))
