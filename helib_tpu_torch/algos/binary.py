"""Bit-sliced binary arithmetic over vectors of ciphertexts
(helib_tpu.algos.binary).

HElib's binaryArith/binaryCompare (src/binaryArith.cpp,
src/binaryCompare.cpp): numbers are little-endian lists of mod-2
ciphertexts (one bit position per ctxt, SIMD over slots: the CtPtrs
abstraction of HElib's CtPtrs.h).

XOR = add, AND = multiply (p=2).
"""

from __future__ import annotations

import numpy as np


def _xor(a, b):
    return a.copy().add(b)


def _and(a, b, key):
    return a.multiply(b, key)


def _zero(ea, bit):
    z = bit.copy()
    z.mul_constant_poly(np.zeros(1, dtype=np.int64))
    return z


def _const_one(ea, like):
    out = like.copy()
    out.mul_constant_poly(np.zeros(1, dtype=np.int64))
    out.add_constant_poly(np.ones(1, dtype=np.int64))
    return out


def add_two_numbers(ea, a: list, b: list, key, out_bits: int | None = None):
    """Binary addition (HElib's addTwoNumbers, binaryArith.cpp:644).
    Ripple-carry; a, b little-endian bit lists (may differ in length)."""
    n = max(len(a), len(b))
    out_bits = out_bits or (n + 1)
    carry = None
    out = []
    for i in range(min(out_bits, n + 1)):
        ai = a[i] if i < len(a) else None
        bi = b[i] if i < len(b) else None
        if i >= n:
            if carry is not None:
                out.append(carry)
            break
        if ai is None:
            s = bi.copy() if carry is None else _xor(bi, carry)
            c = None if carry is None else _and(bi, carry, key)
        elif bi is None:
            s = ai.copy() if carry is None else _xor(ai, carry)
            c = None if carry is None else _and(ai, carry, key)
        else:
            axb = _xor(ai, bi)
            s = axb if carry is None else _xor(axb, carry)
            ab = _and(ai, bi, key)
            if carry is None:
                c = ab
            else:
                c = _xor(ab, _and(axb, carry, key))
        out.append(s)
        carry = c
    return out[:out_bits]


def three_for_two(ea, a: list, b: list, c: list, key):
    """Carry-save: three numbers -> two with the same sum (HElib's
    addManyNumbers' 3-for-2 step, binaryArith.cpp:895)."""
    n = max(len(a), len(b), len(c))

    def bit(x, i):
        return x[i] if i < len(x) else None

    s, carry = [], [None]   # carry output is shifted up by one
    for i in range(n):
        bits = [v for v in (bit(a, i), bit(b, i), bit(c, i)) if v is not None]
        if len(bits) == 1:
            s.append(bits[0].copy())
            carry.append(None)
        elif len(bits) == 2:
            s.append(_xor(bits[0], bits[1]))
            carry.append(_and(bits[0], bits[1], key))
        else:
            x, y, z = bits
            xy = _xor(x, y)
            s.append(_xor(xy, z))
            # maj(x,y,z) = xy*z + x*y  (GF(2))
            carry.append(_xor(_and(xy, z, key), _and(x, y, key)))
    return s, [v for v in carry]


def add_many_numbers(ea, nums: list, key, out_bits: int | None = None):
    """Sum a list of binary numbers via 3-for-2 reduction then one final
    two-number add (HElib's addManyNumbers, binaryArith.cpp:895)."""
    nums = [list(v) for v in nums]
    while len(nums) > 2:
        a, b, c = nums.pop(), nums.pop(), nums.pop()
        s, cr = three_for_two(ea, a, b, c, key)
        nums.append([x for x in s])
        nums.append([x for x in cr if True])
        # strip leading Nones in the carry number
        nums[-1] = [(_zero(ea, s[0]) if v is None else v) for v in nums[-1]]
    if len(nums) == 1:
        return nums[0]
    a, b = nums
    return add_two_numbers(ea, a, b, key, out_bits)


def mult_two_numbers(ea, a: list, b: list, key, out_bits: int | None = None):
    """Binary multiplication via partial products + multi-add (HElib's
    multTwoNumbers, binaryArith.cpp:1027)."""
    out_bits = out_bits or (len(a) + len(b))
    partials = []
    for i, bi in enumerate(b):
        row = [None] * i + [_and(aj, bi, key) for aj in a]
        row = [(_zero(ea, bi) if v is None else v) for v in row[:out_bits]]
        partials.append(row)
    return add_many_numbers(ea, partials, key, out_bits)


def negate_number(ea, a: list, key, width: int):
    """Two's complement negation: flip bits, add 1."""
    flipped = []
    for i in range(width):
        if i < len(a):
            f = a[i].copy()
            f.add_constant_poly(np.ones(1, dtype=np.int64))
        else:
            f = _const_one(ea, a[0])
        flipped.append(f)
    one = [_const_one(ea, a[0])]
    return add_two_numbers(ea, flipped, one, key, width)


def compare_two_numbers(ea, a: list, b: list, key):
    """(gt, eq) indicator bits (HElib's compareTwoNumbers,
    binaryCompare.cpp:255): gt = [a > b], eq = [a == b], slot-wise."""
    n = max(len(a), len(b))

    def bit(x, i):
        if i < len(x):
            return x[i]
        return None

    eq_suffix = None     # all bits above i equal
    gt = None
    for i in range(n - 1, -1, -1):
        ai, bi = bit(a, i), bit(b, i)
        if ai is None:
            ai = _zero(ea, b[0])
        if bi is None:
            bi = _zero(ea, a[0])
        ne = _xor(ai, bi)                      # bits differ
        gt_here = _and(ai, _xor(bi, _const_one(ea, bi)), key)  # ai & ~bi
        if eq_suffix is None:
            gt = gt_here
            eq_suffix = _xor(ne, _const_one(ea, ne))
        else:
            t = _and(eq_suffix, gt_here, key)
            gt = _xor(gt, t)
            eq_suffix = _and(eq_suffix, _xor(ne, _const_one(ea, ne)), key)
    return gt, eq_suffix


def bitwise_xor(ea, a: list, b: list):
    """Slot-wise XOR per bit position (HElib's bitwiseXOR)."""
    n = max(len(a), len(b))
    out = []
    for i in range(n):
        if i >= len(a):
            out.append(b[i].copy())
        elif i >= len(b):
            out.append(a[i].copy())
        else:
            out.append(_xor(a[i], b[i]))
    return out


def bitwise_and(ea, a: list, b: list, key):
    return [_and(x, y, key) for x, y in zip(a, b)]


def bitwise_or(ea, a: list, b: list, key):
    """x | y = x + y + x*y over GF(2) (HElib's bitwiseOr)."""
    return [_xor(_xor(x, y), _and(x, y, key)) for x, y in zip(a, b)]


def bitwise_not(ea, a: list):
    out = []
    for x in a:
        t = x.copy()
        t.add_constant_poly(np.ones(1, dtype=np.int64))
        out.append(t)
    return out


def left_shift(ea, a: list, amt: int, width: int):
    """Multiply by 2^amt (zero-fill low bits), HElib's leftBitwiseShift."""
    z = [_zero(ea, a[0]) for _ in range(amt)]
    return (z + [x.copy() for x in a])[:width]


def right_bitwise_shift(ea, a: list, amt: int, width: int | None = None):
    """Shift toward the LSB end (divide by 2^amt), zero-fill at the MSB end.

    Complement of leftBitwiseShift (HElib's binaryArith.h:91); the
    HElib exposes only the left direction, this rounds out the API.
    """
    width = width or len(a)
    out = [a[i + amt].copy() for i in range(max(0, len(a) - amt))]
    while len(out) < width:
        out.append(_zero(ea, a[0]))
    return out[:width]


def bitwise_rotate(ea, a: list, rotamt: int):
    """Rotate bit positions: out[i] = in[(i - rotamt) mod n], rotating
    toward the MSB end like leftBitwiseShift (HElib's bitwiseRotate,
    binaryArith.h:103, binaryArith.cpp:572)."""
    n = len(a)
    rotamt %= n
    return [a[(i - rotamt) % n].copy() for i in range(n)]


def concat_binary_nums(a: list, b: list):
    """Concatenate: `a` occupies the low bit positions, `b` the high ones
    (HElib's concatBinaryNums, binaryArith.cpp:535)."""
    return [x.copy() for x in a] + [x.copy() for x in b]


def split_binary_nums(a: list, left_size: int):
    """Split into (low `left_size` bits, remaining high bits)
    (HElib's splitBinaryNums, binaryArith.cpp:547)."""
    return ([x.copy() for x in a[:left_size]],
            [x.copy() for x in a[left_size:]])


# ---------------------------------------------------------------------------
# Compression adders: sum up to 15 same-significance bits into a short
# counter (HElib's three4Two / seven4Three / fifteen4Four /
# fifteenOrLess4Four, binaryArith.cpp:1080-1341).
# ---------------------------------------------------------------------------

def _three_for_two_bits(x, y, z, key):
    """(lsb, msb) of x+y+z for single bits; inputs may be None (= zero).
    lsb = x^y^z, msb = majority = (x^y)·z ^ x·y (HElib's three4Two)."""
    bits = [v for v in (x, y, z) if v is not None]
    if not bits:
        return None, None
    if len(bits) == 1:
        return bits[0].copy(), None
    if len(bits) == 2:
        return _xor(bits[0], bits[1]), _and(bits[0], bits[1], key)
    x, y, z = bits
    xy = _xor(x, y)
    return _xor(xy, z), _xor(_and(xy, z, key), _and(x, y, key))


def seven_for_three(ea, bits: list, key, size_limit: int = 3):
    """Sum of up to 7 bits as a 3-bit counter [lsb..msb]
    (HElib's seven4Three, binaryArith.cpp:1128-1178)."""
    bits = list(bits) + [None] * (7 - len(bits))
    b1, b2 = _three_for_two_bits(bits[0], bits[1], bits[2], key)
    b3, b4 = _three_for_two_bits(bits[3], bits[4], bits[5], key)
    c1, c2 = _three_for_two_bits(bits[6], b1, b3, key)
    out = [c1 if c1 is not None else _zero(ea, _first(bits))]
    if size_limit < 2:
        return out
    c3, c4 = _three_for_two_bits(b2, b4, None, key)
    d1, _ = _three_for_two_bits(c2, c3, None, key)
    out.append(d1 if d1 is not None else _zero(ea, out[0]))
    if size_limit < 3:
        return out
    # d2 = carry(c2,c3) ^ c4
    d2, _ = (None, None)
    if c2 is not None and c3 is not None:
        d2 = _and(c2, c3, key)
    if c4 is not None:
        d2 = c4.copy() if d2 is None else _xor(d2, c4)
    out.append(d2 if d2 is not None else _zero(ea, out[0]))
    return out


def _first(bits):
    for b in bits:
        if b is not None:
            return b
    raise ValueError("all-None bit list")


def fifteen_for_four(ea, bits: list, key, size_limit: int = 4):
    """Sum of up to 15 bits as a 4-bit counter [lsb..msb]
    (HElib's fifteen4Four scheme, binaryArith.cpp:1180-1315)."""
    z = lambda: _zero(ea, _first(bits))
    bits = list(bits) + [None] * (15 - len(bits))
    b = {}
    for k in range(5):                      # b2k+2 b2k+1 = 3for2(in[3k..3k+2])
        lo, hi = _three_for_two_bits(bits[3 * k], bits[3 * k + 1],
                                     bits[3 * k + 2], key)
        b[2 * k + 1], b[2 * k + 2] = lo, hi
    c1, c2 = _three_for_two_bits(b[1], b[3], b[5], key)
    c3, c4 = _three_for_two_bits(b[2], b[4], b[6], key)
    d1, d2 = _three_for_two_bits(b[7], b[9], c1, key)
    out = [d1 if d1 is not None else z()]
    if size_limit < 2:
        return out
    d3, d4 = _three_for_two_bits(b[8], b[10], c2, key)
    e1, e2 = _three_for_two_bits(c3, d2, d3, key)
    out.append(e1 if e1 is not None else z())
    if size_limit < 3:
        return out
    e3, e4 = _three_for_two_bits(c4, d4, None, key)
    f1, f2c = _three_for_two_bits(e2, e3, None, key)
    out.append(f1 if f1 is not None else z())
    if size_limit < 4:
        return out
    # f2 = e4 ^ carry(e2,e3)
    f2 = None
    if e4 is not None:
        f2 = e4.copy()
    if f2c is not None:
        f2 = f2c if f2 is None else _xor(f2, f2c)
    out.append(f2 if f2 is not None else z())
    return out


def fifteen_or_less_4_four(ea, bits: list, key, size_limit: int = 4):
    """Sum up to 15 same-significance bits (entries may be None) into a
    little-endian counter; returns (counter_bits, n_meaningful) like the
    HElib's return count (HElib's fifteenOrLess4Four,
    binaryArith.cpp:1317-1341)."""
    live = [b for b in bits if b is not None]
    if len(bits) > 15:
        raise ValueError("at most 15 input bits")
    n = len(live)
    if n == 0:
        return [], 0
    if n > 7:
        return fifteen_for_four(ea, bits, key, size_limit), 4
    if n > 3:
        out = seven_for_three(ea, live, key, min(size_limit, 3))
        return out, 3
    lo, hi = _three_for_two_bits(*(live + [None] * (3 - n)), key)
    out = [lo]
    if hi is not None and size_limit >= 2:
        out.append(hi)
    return out, len(out)


def binary_cond(ea, cond, a: list, b: list, key):
    """Bit-sliced mux: cond ? a : b (HElib's binaryCond,
    binaryArith.h:259)."""
    out = []
    n = max(len(a), len(b))
    for i in range(n):
        ai = a[i] if i < len(a) else _zero(ea, cond)
        bi = b[i] if i < len(b) else _zero(ea, cond)
        # cond*ai + (1-cond)*bi = bi + cond*(ai xor bi)  over GF(2)
        d = _xor(ai, bi)
        out.append(_xor(bi, _and(cond, d, key)))
    return out


def binary_mask(ea, cond, a: list, key):
    """Zero out a where cond=0 (HElib's binaryMask)."""
    return [_and(x, cond, key) for x in a]


def encrypt_number(ea, pk, rng, values, width: int):
    """Encrypt slot-wise integers as a width-bit binary number."""
    vals = np.asarray(values, dtype=np.int64)
    bits = []
    for i in range(width):
        bits.append(ea.encrypt(list((vals >> i) & 1), pk, rng))
    return bits


def decrypt_number(ea, sk, bits: list) -> np.ndarray:
    out = np.zeros(ea.nslots, dtype=np.int64)
    for i, b in enumerate(bits):
        out += ea.decrypt_ints(b, sk).astype(np.int64) << i
    return out
