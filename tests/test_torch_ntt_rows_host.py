"""K2 and K4/K5's CUDA sources (ops/csrc/ntt.cu, ntt2.cu and their device
template ntt_rows.cuh in its forward, inverse and convolution modes) run on
the host: compiled by g++ against the stand-in CUDA runtime of
test_torch_conv_rows_host.py (threads as std::threads, barriers as
std::barriers, a cluster's distributed shared memory as its CTAs'
buffers), one g++ per source, once per session of this module.  Their C
entries are called with CPU tensors and held bit for bit to ntt_plain and
conv_plain (which ntt2_plain and conv2_plain equal at every k,
test_torch_ntt2.py): the shipped entries at n = 8 .. 65536 (one CTA a row,
the n = 32768 configuration, 4-CTA clusters at n = 65536), K4 and K5 at
every k, and the template on 1-, 2- and 4-CTA clusters of 64 threads
through the test's own entries (HARNESS_CU)."""

import ctypes

import numpy as np
import pytest
import torch

from helib_tpu_torch.nt.primegen import gen_primes
from helib_tpu_torch.ops import ntt as tntt
from helib_tpu_torch.ops.conv import conv_plain
from helib_tpu_torch.ops.modops import shoup, to_device
from helib_tpu_torch.ops.ntt_fused import ntt_plain

from test_torch_conv_rows_host import build_host_libs

torch.set_num_threads(1)

# The template's NTT modes on clusters of 1, 2 and 4 CTAs of 64 threads at
# any size, with helib_ntt_launch's signature.
HARNESS_CU = r"""
#include "ntt_rows.cuh"

template <int kCluster>
int run(const void* x, void* out, long long rows, int log_n, int P,
        const void* w, const void* wsh, const void* q, int inverse,
        void* stream) {
  using helib::PrimeRows, helib::Rows, helib::kMaxK;
  const auto s = static_cast<cudaStream_t>(stream);
  if (inverse)
    return Rows<PrimeRows, helib::kInverse, kMaxK, kCluster, 64, 1>::launch(
        x, out, rows, log_n, P, nullptr, nullptr, w, wsh, nullptr, nullptr,
        q, s);
  return Rows<PrimeRows, helib::kForward, kMaxK, kCluster, 64, 1>::launch(
      x, out, rows, log_n, P, w, wsh, nullptr, nullptr, nullptr, nullptr, q,
      s);
}

#define NTT_ARGS                                                          \
  const void *x, void *out, long long rows, int log_n, int P,             \
      const void *w, const void *wsh, const void *q, int inverse,         \
      void *stream
#define NTT_NAMES x, out, rows, log_n, P, w, wsh, q, inverse, stream

extern "C" {
int ntt_cluster1(NTT_ARGS) { return run<1>(NTT_NAMES); }
int ntt_cluster2(NTT_ARGS) { return run<2>(NTT_NAMES); }
int ntt_cluster4(NTT_ARGS) { return run<4>(NTT_NAMES); }
}
"""

P_ = ctypes.c_void_p
NTT_ARGTYPES = [P_, P_, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, P_,
                P_, P_, ctypes.c_int]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{C entry name: function} of ntt.cu, ntt2.cu and the harness."""
    built = build_host_libs(tmp_path_factory, "ntt_rows_host",
                            ("ntt", "ntt2"), HARNESS_CU)
    out = {}
    for lib, entry, extra in (
            ("ntt", "helib_ntt_launch", []),
            ("ntt2", "helib_ntt2_launch", [ctypes.c_int]),
            ("harness", "ntt_cluster1", []),
            ("harness", "ntt_cluster2", []),
            ("harness", "ntt_cluster4", []),
            ("ntt2", "helib_ntt2_launch_conv", None)):
        fn = getattr(built[lib], entry)
        fn.restype = ctypes.c_int
        fn.argtypes = (NTT_ARGTYPES + extra + [P_] if extra is not None else
                       [P_, P_, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int] + [P_] * 7 + [ctypes.c_int, P_])
        out[entry] = fn
    return out


def _ntt_case(n, P, lead, seed):
    qs = np.array(gen_primes(2 * n, P), dtype=np.uint32)
    tab = tntt.Pow2NTT(qs, n, negacyclic=True)
    t = tab.tree("cpu")
    flat = {k: to_device(v, "cpu") for k, v in tab.flat().items()}
    rng = np.random.default_rng(seed)
    x = rng.integers(0, qs[:, None].astype(np.int64), lead + (P, n))
    return to_device(x.astype(np.uint32), "cpu"), t, flat


def _run_ntt(fn, x, t, flat, inverse, *extra):
    n, P = x.shape[-1], x.shape[-2]
    keys = ("itw_all", "itw_all_sh") if inverse else ("tw_all", "tw_all_sh")
    out = torch.full_like(x, -1)
    err = fn(x.data_ptr(), out.data_ptr(), x.numel() // n,
             n.bit_length() - 1, P, *(flat[k].data_ptr() for k in keys),
             t["q"].data_ptr(), int(inverse), *extra, None)
    assert err == 0
    return out


def _check_both_directions(fn, n, P, lead, seed, *extra):
    x, t, flat = _ntt_case(n, P, lead, seed)
    fwd = _run_ntt(fn, x, t, flat, False, *extra)
    assert torch.equal(fwd, ntt_plain(x, t, inverse=False))
    inv = _run_ntt(fn, x, t, flat, True, *extra)
    assert torch.equal(inv, ntt_plain(x, t, inverse=True))


@pytest.mark.parametrize("n,P,lead", [(8, 3, (2,)), (64, 5, (2,)),
                                      (2048, 3, ()), (32768, 1, (2,)),
                                      (65536, 2, ())])
def test_ntt_source_on_host_matches_plain(libs, n, P, lead):
    """K2's entry, forward and inverse: one composite at n = 8 (x in, out
    back), one CTA a row to n = 16384, the shipped n = 32768 and n = 65536
    (4-CTA cluster) configurations; odd P and a lead dim."""
    _check_both_directions(libs["helib_ntt_launch"], n, P, lead, seed=n + P)


@pytest.mark.parametrize("n", [256, 4096])
@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_ntt_template_on_clusters_matches_plain(libs, cluster, n):
    """The forward and inverse modes on a cluster of 1, 2 or 4 CTAs of 64
    threads: the cross composite, the global stage and block offsets, x
    read and out written straight from and to device memory."""
    _check_both_directions(libs[f"ntt_cluster{cluster}"], n, 3, (2,),
                           seed=n + cluster)


@pytest.mark.parametrize("n", [64, 4096, 65536])
def test_ntt2_source_on_host_matches_plain_at_every_k(libs, n):
    """K4's entry at k = 1, 2, 3 (at n = 65536 on K2's 4-CTA clusters)."""
    for k in (1, 2, 3):
        _check_both_directions(libs["helib_ntt2_launch"], n, 3, (), n + k, k)


@pytest.mark.parametrize("n", [8, 2048])
def test_conv2_source_on_host_matches_plain_at_every_k(libs, n):
    """K5's entry at k = 1, 2, 3: K1's convolution on the row-major
    layout [lead, 3, P, n]."""
    raux = tntt.aux_primes().astype(np.int64)
    rng = np.random.default_rng(n)
    P = 3
    x = to_device(rng.integers(0, raux[:, None, None], (2, 3, P, n))
                  .astype(np.uint32), "cpu")
    kh = rng.integers(0, raux[:, None, None], (3, P, n)).astype(np.uint32)
    khsh = to_device(shoup(kh, raux[:, None, None].astype(np.uint64)), "cpu")
    kh = to_device(kh, "cpu")
    aux = tntt.aux_tree(n, "cpu")["aux"]
    want = conv_plain(x, aux, kh, khsh)
    ptr = [a.data_ptr() for a in (aux["tw_all"], aux["tw_all_sh"],
                                  aux["itw_all"], aux["itw_all_sh"], kh, khsh,
                                  aux["q"])]
    for k in (1, 2, 3):
        out = torch.full_like(x, -1)
        assert libs["helib_ntt2_launch_conv"](
            x.data_ptr(), out.data_ptr(), x.numel() // n, n.bit_length() - 1,
            P, *ptr, k, None) == 0
        assert torch.equal(out, want)


def test_ntt_entries_reject_bad_sizes(libs):
    """A size or a k out of range is an invalid value (1) and launches
    nothing: n = 2^17 and 2^2, k = 0 and 4, K5 at n = 65536."""
    ntt, ntt2 = libs["helib_ntt_launch"], libs["helib_ntt2_launch"]
    null = [None] * 3
    assert ntt(None, None, 1, 17, 1, *null, 0, None) == 1
    assert ntt(None, None, 1, 2, 1, *null, 1, None) == 1
    assert ntt2(None, None, 1, 16, 1, *null, 0, 0, None) == 1
    assert ntt2(None, None, 1, 16, 1, *null, 0, 4, None) == 1
    assert libs["helib_ntt2_launch_conv"](None, None, 3, 16, 1,
                                          *[None] * 7, 3, None) == 1
