"""ops.embed_max, the canonical-embedding max of the measured mod-switch
noise: the plain version against norms._largest (helib_tpu's host FFT) at
odd prime, odd composite and power-of-2 m; the kernel source
(csrc/embed_max.cu) on the host through the stand-in CUDA runtime of
test_torch_conv_rows_host.py, held to the plain version; the wrapper's
refusals; and BGV Ctxt.mod_down_to on the CPU, one embed_max call a
measured mod-down, against helib_tpu's noise."""

import ctypes

import numpy as np
import pytest
import torch

from helib_tpu.context import Context as JContext
from helib_tpu.keys import SecKey as JSecKey, PubKey as JPubKey

from helib_tpu_torch import convert, ctxt as tctxt
from helib_tpu_torch.context import Context as TContext
from helib_tpu_torch.keys import SecKey as TSecKey, PubKey as TPubKey
from helib_tpu_torch.norms import _largest
from helib_tpu_torch.ops._build import launch_counts
from helib_tpu_torch.ops import embed_max as em

from test_torch_conv_rows_host import build_host_libs

torch.set_num_threads(1)

# (m, n): odd composite (phi(m) < m - 1), odd prime, power of 2; n the
# row's length: m at odd m (coefficients mod X^m - 1, as the port's rows
# hold them), m/2 at a power of 2, and a row of phi(m) < m coefficients
SIZES = [(31, 31), (4095, 4095), (4095, 1728), (8009, 8009),
         (32003, 32003), (256, 128), (65536, 32768)]


def _n(m: int) -> int:
    return m // 2 if m & (m - 1) == 0 else m


def _rows(m: int, R: int, seed: int, n: int | None = None) -> torch.Tensor:
    """R seeded float32 rows of balanced remainders in [-1/2, 1/2)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((R, n or _n(m))) - 0.5).astype(
        np.float32))


def _host_max(row: torch.Tensor, m: int) -> float:
    return _largest(row.numpy().astype(np.float64), m, m & (m - 1) == 0)


@pytest.mark.parametrize("m,n", SIZES)
def test_plain_matches_norms_largest(m, n):
    """Each row's max equals the host FFT's to 1e-12 relative (the host's
    power-of-2 twist, zeta ** k, is itself ~3e-13 off at n = 32768)."""
    x = _rows(m, 3, seed=m + n, n=n)
    got = em.embed_max_plain(x, em.embed_tables(m, n, "cpu"))
    assert got.dtype == torch.float64 and got.shape == (3,)
    for r in range(3):
        want = _host_max(x[r], m)
        assert abs(got[r].item() - want) <= 1e-12 * want


@pytest.mark.parametrize("m", [31, 8009, 256])
def test_zero_row_gives_zero(m):
    x = _rows(m, 2, seed=m + 1)
    x[1] = 0.0
    got = em.embed_max(x, em.embed_tables(m, _n(m), "cpu"))
    assert got[1].item() == 0.0 and got[0].item() > 0.0


@pytest.mark.parametrize("m", [4095, 256])
def test_rows_are_independent(m):
    """Several rows give the per-row maxima: each row alone, and in any
    order, reads the same value."""
    tab = em.embed_tables(m, _n(m), "cpu")
    x = _rows(m, 4, seed=m + 2)
    x[1] *= 1000.0
    together = em.embed_max_plain(x, tab)
    flipped = em.embed_max_plain(x.flip(0).contiguous(), tab)
    assert torch.equal(together, flipped.flip(0))
    for r in range(4):
        alone = em.embed_max_plain(x[r:r + 1], tab)[0]
        assert abs(alone.item() - together[r].item()) <= 1e-13 * alone.item()


def test_tables_at_m8009_stay_under_a_megabyte():
    tab = em.embed_tables(8009, 8009, "cpu")
    assert tab["log_l"] == 14          # L = 16384 >= 8009 + 8009 - 1
    held = sum(t.numel() * t.element_size() for t in tab.values()
               if isinstance(t, torch.Tensor))
    assert held < 1 << 20


def test_wrapper_refusals():
    tab = em.embed_tables(31, 31, "cpu")
    before = launch_counts.copy()
    with pytest.raises(ValueError):
        em.embed_max(torch.zeros(2, 30), tab)             # wrong length
    with pytest.raises(ValueError):
        em.embed_max(torch.zeros(2, 31, dtype=torch.float64), tab)
    with pytest.raises(ValueError):
        em.embed_max_cuda(torch.zeros(2, 31), tab)       # a CPU tensor
    with pytest.raises(ValueError):
        em.embed_tables(31, 32, "cpu")                   # n > m
    with pytest.raises(ValueError):
        em.embed_tables(1 << 22, 1 << 21, "cpu")         # L = 2^23
    em.embed_max(torch.zeros(2, 31), tab)                # the plain version
    assert launch_counts == before


# -- the kernel source on the host --------------------------------------

@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    built = build_host_libs(tmp_path_factory, "embed_max_host",
                            ("embed_max",), "// no entries of its own\n")
    fn = built["embed_max"].helib_embed_max_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int] + [
        ctypes.c_void_p] * 5
    return fn


def _run_source(fn, x, tab):
    R = x.shape[0]
    out = torch.full((R,), -1.0, dtype=torch.float64)
    work = torch.full((R, 1 << tab["log_l"], 2), float("nan"),
                      dtype=torch.float64)
    err = fn(x.data_ptr(), out.data_ptr(), work.data_ptr(), R, tab["n"],
             tab["m"], tab["log_l"], tab["chirp"].data_ptr(),
             tab["bhat"].data_ptr(), tab["tw"].data_ptr(),
             tab["mask"].data_ptr(), None)
    assert err == 0
    return out


@pytest.mark.parametrize("m,R", [(3, 1), (31, 3), (64, 2), (4095, 2),
                                 (8009, 2), (32003, 1)])
def test_kernel_source_on_host_matches_plain(entry, m, R):
    """The three launches (four-step split L = L1 x L2 with L1 = L2 and
    L2 = 2 L1, one to many sequences a tile) on R rows, the last of them
    zero: the plain version's max to 1e-12 relative, and 0 for the zero
    row."""
    tab = em.embed_tables(m, _n(m), "cpu")
    x = _rows(m, R, seed=m + 3)
    x[-1] = 0.0
    got = _run_source(entry, x, tab)
    want = em.embed_max_plain(x, tab)
    assert got[-1].item() == 0.0
    assert torch.allclose(got, want, rtol=1e-12, atol=0.0)


def test_kernel_entry_rejects_bad_shapes(entry):
    """A transform shorter than n + m - 1, or above 2^22, or n > m is an
    invalid value (1) and launches nothing; no rows is a no-op."""
    null = [None] * 5
    assert entry(None, None, None, 1, 31, 31, 5, *null, None) == 1
    assert entry(None, None, None, 1, 31, 31, 23, *null, None) == 1
    assert entry(None, None, None, 1, 32, 31, 7, *null, None) == 1
    assert entry(None, None, None, 0, 31, 31, 6, *null, None) == 0


# -- the measured mod-down ----------------------------------------------

PARAMS = dict(m=31, p=2, r=1, bits=300, c=3)


@pytest.fixture(scope="module")
def bgv():
    jc, tc = JContext(**PARAMS), TContext(**PARAMS, device="cpu")
    jpk, tpk = JPubKey(JSecKey(jc, seed=7)), TPubKey(TSecKey(tc, seed=7))
    pt = np.random.default_rng(2).integers(0, 2, jc.phi_m)
    return tc, tpk, jpk.encrypt_bgv(pt, np.random.default_rng(5))


def test_measured_mod_down_matches_helib_tpu(bgv, monkeypatch):
    """Measurement on: the noise after dropping one ciphertext prime, then
    two more, equals helib_tpu's within 1e-9, below the worst-case bound
    (the measurement counts), through one embed_max call of both parts a
    mod-down."""
    tc, tpk, jct = bgv
    monkeypatch.delenv("HELIB_EXACT_MODSWITCH", raising=False)
    calls = []
    real = tctxt.embed_max

    def counted(x, tab):
        calls.append(tuple(x.shape))
        return real(x, tab)
    monkeypatch.setattr(tctxt, "embed_max", counted)
    parts = [((h.powS, h.powX, h.keyID), np.asarray(d)) for h, d in jct.parts]
    t = convert.ctxt_from_arrays(tc, tpk, parts, jct.k, jct.special,
                                 jct.ptxt_space, jct.noise, jct.intFactor)
    j = jct.copy()
    for target in (jct.k - 1, jct.k - 3):
        j.mod_down_to(target, False)
        t.mod_down_to(target, False)
        assert abs(t.noise - j.noise) <= 1e-9
    assert calls == [(2, tc.n_eval)] * 2
    monkeypatch.setenv("HELIB_EXACT_MODSWITCH", "0")
    bound = convert.ctxt_from_arrays(tc, tpk, parts, jct.k, jct.special,
                                     jct.ptxt_space, jct.noise,
                                     jct.intFactor)
    bound.mod_down_to(jct.k - 1, False)
    bound.mod_down_to(jct.k - 3, False)
    assert len(calls) == 2 and t.noise < bound.noise
