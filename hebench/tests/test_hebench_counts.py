"""counts.py against bounds worked out by hand at m=8009 and m=65536."""

import json
import os

import pytest

import _tiny
from hebench import counts

HBM, MUL = 3.35e12, 67e12 / 4


def config(name):
    with open(os.path.join(_tiny.ROOT, "hebench", "configs",
                           name + ".json")) as f:
        return json.load(f)


def test_transforms_from_sizes():
    # L = 13 primes in digits 5, 4, 4, S = 5: the digit decomposition
    # inverts 13 rows and extends each digit onto 18 - its size; each of
    # the two parts drops the 5 specials (inverse) and corrects 13 rows
    assert counts.transforms(config("bgv_m8009")) == [
        (True, 13), (False, 13), (False, 14), (False, 14),
        (True, 5), (False, 13), (True, 5), (False, 13)]
    assert counts.transforms(config("ckks_m65536")) == [
        (True, 15), (False, 15), (False, 15), (False, 15),
        (True, 5), (False, 15), (True, 5), (False, 15)]


def test_bgv_bound_by_hand():
    # one K1 launch on x [16, 3, 13, 16384]: 624 rows, 16 levels of Shoup
    # products (14 stages + khat + B^-1) at 3 multiplies each
    b, o = counts.conv_bound_ms((16, 3, 13, 16384), (3, 13, 16384))
    assert o == pytest.approx(624 * 3 * 16384 * 16 / MUL * 1e3)
    assert b == pytest.approx(4 * (2 * 10223616 + 2 * 638976 + 196611)
                              / HBM * 1e3)
    total = sum(max(counts.conv_bound_ms((16, 3, P, 16384), (3, P, 16384)))
                for _, P in counts.transforms(config("bgv_m8009")))
    got = counts.transform_bound_ms(config("bgv_m8009"), 16)
    assert got == pytest.approx(total)
    # 90 rows, each lifted to 48 (16 ciphertexts x 3 auxiliary primes):
    # multiplies bound every transform
    assert got == pytest.approx(90 * 48 * 3 * 16384 * 16 / MUL * 1e3)
    for _, P in counts.transforms(config("bgv_m8009")):
        b, o = counts.conv_bound_ms((16, 3, P, 16384), (3, P, 16384))
        assert o > b


def test_ckks_bound_by_hand():
    n = 32768
    fwd = lambda P: max(4 * (2 * 16 * P * n + 2 * P * n + P) / HBM,
                        16 * P * 3 * (n // 2) * 15 / MUL) * 1e3
    inv = lambda P: max(4 * (2 * 16 * P * n + 2 * P * n + P) / HBM,
                        16 * P * 3 * ((n // 2) * 15 + n) / MUL) * 1e3
    want = inv(15) + 3 * fwd(15) + 2 * (inv(5) + fwd(15))
    got = counts.transform_bound_ms(config("ckks_m65536"), 16)
    assert got == pytest.approx(want)
