"""ops.basis_ext, the RNS basis extension of the key switch's digits and the
scaled mod-down: the plain version against exact integer arithmetic; the
kernel source (csrc/basis_ext.cu) on the host through the stand-in CUDA
runtime of test_torch_conv_rows_host.py, held to the plain version bit for
bit over the source and target counts the port runs (kd 1-65, T 13-259),
a ragged N, leading batch dims, strided rows, a row subset of the targets
(as a limb-mesh rank lifts), sums within 1e-9 of a rounding boundary, the
float64 remainder and a mod-p^r target row; and the wrapper's refusals."""

import ctypes
from fractions import Fraction

import numpy as np
import pytest
import torch

from helib_tpu_torch.nt.primegen import gen_primes
from helib_tpu_torch.ops._build import launch_counts
from helib_tpu_torch.ops import basis_ext as be
from helib_tpu_torch.ops.modops import to_device

from test_torch_conv_rows_host import build_host_libs

torch.set_num_threads(1)

# 65 source and 259 other primes below 2^30, as many as the m=32003 key
# switch lifts from and onto
PRIMES = gen_primes(2, 65 + 259)
SOURCES, OTHERS = PRIMES[:65], PRIMES[65:]


def _inputs(kd, T, n, lead, seed, own_rows=False):
    """Tables from kd source primes onto T targets (with own_rows the
    targets start with the sources, as a digit lifts onto every row) and
    seeded residues x [*lead, kd, n]."""
    d = SOURCES[:kd]
    t = (d + OTHERS)[:T] if own_rows else OTHERS[:T]
    rng = np.random.default_rng(seed)
    x = rng.integers(0, np.array(d, dtype=np.int64)[:, None],
                     lead + (kd, n)).astype(np.uint32)
    return be.basis_ext_tables(d, t, "cpu"), to_device(x, "cpu")


def _exact(x_col, d, t):
    """The lift of one column by Python integers: (delta [T], z - alpha)
    with z summed in float64 left to right, as both versions sum it."""
    D = 1
    for di in d:
        D *= di
    y = [int(xi) * pow(D // di % di, -1, di) % di for xi, di in zip(x_col, d)]
    z = np.float64(0.0)
    for yi, di in zip(y, d):
        z = z + np.float64(yi) * np.float64(1.0 / np.float64(di))
    alpha = int(np.floor(z)) + int(z - np.floor(z) >= 0.5)
    v = sum(yi * (D // di) for yi, di in zip(y, d)) - alpha * D
    return [v % tj for tj in t], float(z - alpha)


def test_plain_matches_exact_integers():
    tab, x = _inputs(5, 20, 7, (2,), seed=1, own_rows=True)
    d = SOURCES[:5]
    t = (d + OTHERS)[:20]
    got, frac = be.basis_ext_plain(x, tab, want_frac=True)
    xs = x.numpy().view(np.uint32)
    for b in range(2):
        for col in range(7):
            want, want_frac = _exact(xs[b, :, col], d, t)
            assert got[b, :, col].tolist() == want
            assert frac[b, col].item() == want_frac


# -- the kernel source on the host --------------------------------------

@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    built = build_host_libs(tmp_path_factory, "basis_ext_host",
                            ("basis_ext",), "// no entries of its own\n")
    fn = built["basis_ext"].helib_basis_ext_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 8
    return fn


def _run_source(fn, x, tab, want_frac=False):
    """The C entry on CPU tensors, as basis_ext_cuda calls it: x's rows
    contiguous, its batch entries any stride apart."""
    kd, n = x.shape[-2:]
    T = tab["t_q"].shape[0]
    xv = x.reshape(-1, kd, n)
    assert xv.stride(-1) == 1 and xv.stride(-2) == n
    B = xv.shape[0]
    out = torch.full((B, T, n), -1, dtype=torch.int32)
    frac = torch.full((B, n), float("nan"), dtype=torch.float64)
    ptr = [tab[k].data_ptr() for k in ("d_q", "c", "c_sh", "inv_d", "t_q",
                                       "M", "D_mod_t")]
    err = fn(xv.data_ptr(), out.data_ptr(),
             frac.data_ptr() if want_frac else None, B, xv.stride(0), kd, T,
             n, *ptr, None)
    assert err == 0
    lead = x.shape[:-2]
    return out.reshape(*lead, T, n), frac.reshape(*lead, n)


@pytest.mark.parametrize("T", [13, 18, 20, 194, 259])
@pytest.mark.parametrize("kd", [1, 4, 5, 64, 65])
def test_kernel_source_on_host_matches_plain(entry, kd, T):
    """kd source rows (one to five chunks of 16, the last partial) onto T
    targets (one to nine target tiles of each width the launch picks), a
    batch of 2 and N = 131 (ragged: 262 columns fill 2 tiles of 128 and 6
    of a third), with the frac output: bit for bit."""
    tab, x = _inputs(kd, T, 131, (2,), seed=kd * 1000 + T)
    got, frac = _run_source(entry, x, tab, want_frac=True)
    want, want_frac = be.basis_ext_plain(x, tab, want_frac=True)
    assert torch.equal(got, want)
    assert torch.equal(frac, want_frac)


@pytest.mark.parametrize("kd,T", [(65, 259), (5, 20)])
def test_kernel_source_on_strided_rows_and_two_batch_dims(entry, kd, T):
    """A digit's block, rows [a, a + kd) of a [2, 3, P, N] value: the batch
    entries P N apart, two leading dims folded into the columns; targets
    that start with the source primes themselves."""
    P, a, n = kd + 7, 3, 45
    tab, x = _inputs(kd, T, n, (2, 3), seed=kd + T, own_rows=True)
    full = torch.zeros(2, 3, P, n, dtype=torch.int32)
    full[..., a:a + kd, :] = x
    block = full[..., a:a + kd, :]
    assert not block.is_contiguous()
    got, _ = _run_source(entry, block, tab)
    assert torch.equal(got, be.basis_ext_plain(x, tab)[0])


def test_kernel_source_on_a_row_subset_of_the_targets(entry):
    """A limb-mesh rank's lift (dcrt._digit_consts_rows): the tables'
    target rows index-selected to the rank's rows and the specials, equal
    to those rows of the whole lift."""
    kd, T = 65, 259
    tab, x = _inputs(kd, T, 70, (1,), seed=3, own_rows=True)
    held = torch.tensor(list(range(97, 194)) + list(range(194, 259)))
    sub = dict(tab)
    for key, dim in (("M", 1), ("M_sh", 1), ("t_q", 0), ("D_mod_t", 0),
                     ("D_mod_t_sh", 0)):
        sub[key] = tab[key].index_select(dim, held)
    got, _ = _run_source(entry, x, sub)
    whole = be.basis_ext_plain(x, tab)[0]
    assert torch.equal(got, be.basis_ext_plain(x, sub)[0])
    assert torch.equal(got, whole.index_select(-2, held))


def test_kernel_source_at_the_largest_and_zero_residues(entry):
    """y_i = d_i - 1 in every row (the largest products, 16 a chunk near
    2^64 before a reduction) in one column and y = 0 in the next: bit for
    bit the plain version."""
    kd, T = 65, 259
    d = SOURCES[:kd]
    D = 1
    for di in d:
        D *= di
    col = [(di - 1) * (D // di) % di for di in d]        # y_i = d_i - 1
    x = to_device(np.array([col, [0] * kd] * 3, dtype=np.uint32).T.copy(),
                  "cpu")
    tab = be.basis_ext_tables(d, OTHERS[:T], "cpu")
    got, frac = _run_source(entry, x, tab, want_frac=True)
    want, want_frac = be.basis_ext_plain(x, tab, want_frac=True)
    assert torch.equal(got, want) and torch.equal(frac, want_frac)
    assert got[:, 1].tolist() == [0] * T


def _near_half(d, k_cols: int, seed: int):
    """Columns whose exact z = sum_i y_i / d_i lies within 1e-9 of
    k + 1/2, alternately below and above it (1e-11 away at least, so the
    float64 sum is on the same side): returns (x [len(d), k_cols] uint32,
    the sides, +1 above)."""
    rng = np.random.default_rng(seed)
    kd = len(d)
    ys, sides = [], []
    while len(ys) < k_cols:
        want_above = len(ys) % 2 == 1
        rest = [int(v) for v in rng.integers(0, d[2:])] if kd > 2 else []
        S = sum((Fraction(yi, di) for yi, di in zip(rest, d[2:])),
                Fraction(0))
        k = S.numerator // S.denominator
        # k + 1/2 or k + 3/2, whichever lies within 1 above S
        target = k + (Fraction(1, 2) if S - k < Fraction(1, 2)
                      else Fraction(3, 2))
        for y1 in range(2000):
            part = (target - S - Fraction(y1, d[1])) * d[0]
            y0 = part.numerator // part.denominator + int(want_above)
            if not 0 <= y0 < d[0]:
                continue
            dist = Fraction(y0, d[0]) + Fraction(y1, d[1]) + S - target
            if Fraction(1, 10**11) < abs(dist) < Fraction(1, 10**9):
                ys.append([y0, y1] + rest)
                sides.append(1 if dist > 0 else -1)
                break
    D = 1
    for di in d:
        D *= di
    # x_i = y_i / c_i = y_i (D/d_i) mod d_i
    x = np.array([[yi * (D // di) % di for yi, di in zip(col, d)]
                  for col in ys],
                 dtype=np.uint32).T
    return x, sides


@pytest.mark.parametrize("kd", [2, 5, 65])
def test_rounding_boundary(entry, kd):
    """z within 1e-9 of k + 1/2 on both sides: alpha is k below and k + 1
    above (frac near +1/2 and -1/2), in the kernel and the plain version
    alike, and both equal the exact lift."""
    d = SOURCES[:kd]
    x_np, sides = _near_half(d, 12, seed=kd)
    tab = be.basis_ext_tables(d, OTHERS[:18], "cpu")
    x = to_device(x_np, "cpu")
    got, frac = _run_source(entry, x, tab, want_frac=True)
    want, want_frac = be.basis_ext_plain(x, tab, want_frac=True)
    assert torch.equal(got, want) and torch.equal(frac, want_frac)
    for col, side in enumerate(sides):
        f = frac[col].item()
        assert (0.5 - 1e-8 < f < 0.5) if side < 0 else (-0.5 < f < -0.5 + 1e-8)
        exact, _ = _exact(x_np[:, col], d, OTHERS[:18])
        assert got[:, col].tolist() == exact


@pytest.mark.parametrize("pr", [2, 4, 257, 289])
def test_ptxt_space_row_equals_the_loop_it_replaced(entry, pr):
    """The scaled mod-down's p^r correction as one more target row under
    the modulus p^r: the kernel's and the plain version's last row equal
    the loop dcrt ran before, sum_i (y_i (D/d_i mod p^r)) mod p^r less
    alpha (D mod p^r), and the frac output equals z - alpha."""
    kd, T, n = 65, 194, 40
    d = SOURCES[:kd]
    tab = be.basis_ext_tables(d, OTHERS[:T] + [pr], "cpu")
    rng = np.random.default_rng(pr)
    x = to_device(rng.integers(0, np.array(d, dtype=np.int64)[:, None],
                               (2, kd, n)).astype(np.uint32), "cpu")
    got, frac = _run_source(entry, x, tab, want_frac=True)
    want, want_frac = be.basis_ext_plain(x, tab, want_frac=True)
    assert torch.equal(got, want) and torch.equal(frac, want_frac)
    # the loop, on the plain version's y, z and alpha
    D = tab["D"]
    y = be.mul_mod_shoup(x, tab["c"], tab["c_sh"], tab["d_q"]).to(
        torch.int64)
    z = y[..., 0, :].to(torch.float64) * tab["inv_d"][0]
    for i in range(1, kd):
        z = z + y[..., i, :].to(torch.float64) * tab["inv_d"][i]
    alpha = torch.floor(z)
    alpha = alpha + ((z - alpha) >= 0.5)
    accp = torch.zeros_like(z, dtype=torch.int64)
    for i, di in enumerate(d):
        accp = accp + (y[..., i, :] * ((D // di) % pr)) % pr
    accp = (accp + pr - (alpha.to(torch.int64) * (D % pr)) % pr) % pr
    assert torch.equal(got[..., T, :].to(torch.int64), accp)
    assert torch.equal(frac, z - alpha)


def test_kernel_entry_rejects_bad_shapes(entry):
    """No source or target rows, an empty row, a negative batch or batch
    entries closer than kd n: an invalid value (1), nothing launched; no
    batch is a no-op."""
    null = [None] * 8
    assert entry(None, None, None, 1, 0, 0, 5, 8, *null) == 1
    assert entry(None, None, None, 1, 0, 5, 0, 8, *null) == 1
    assert entry(None, None, None, 1, 0, 5, 5, 0, *null) == 1
    assert entry(None, None, None, -1, 40, 5, 5, 8, *null) == 1
    assert entry(None, None, None, 2, 39, 5, 5, 8, *null) == 1
    assert entry(None, None, None, 0, 40, 5, 5, 8, *null) == 0


# -- the wrapper ----------------------------------------------------------

def test_wrapper_refusals_and_launch_count():
    tab, x = _inputs(5, 18, 16, (2,), seed=4)
    before = launch_counts.copy()
    with pytest.raises(ValueError):
        be.basis_ext(x[..., :4, :], tab)                 # kd rows differ
    with pytest.raises(ValueError):
        be.basis_ext(x.to(torch.int64), tab)
    with pytest.raises(ValueError):
        be.basis_ext_cuda(x, tab)                        # a CPU tensor
    with pytest.raises(ValueError):
        be.basis_ext_tables(SOURCES[:2], [1 << 30], "cpu")
    with pytest.raises(ValueError):
        be.basis_ext_tables(SOURCES[:2], [1], "cpu")
    got, frac = be.basis_ext(x, tab)                     # the plain version
    assert frac is None and got.shape == (2, 18, 16)
    assert torch.equal(got, be.basis_ext_plain(x, tab)[0])
    assert launch_counts == before
