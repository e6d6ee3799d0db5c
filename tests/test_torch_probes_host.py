"""The cost probes' CUDA source (ops/csrc/probes.cu, P1 and P2, with the
row template's helpers composite.cuh and ntt_rows.cuh) run on the host:
compiled by g++ against the stand-in CUDA runtime of
test_torch_conv_rows_host.py (threads as std::threads, barriers as
std::barriers, a cluster's distributed shared memory as its CTAs'
buffers).  The test's harness source includes probes.cu, so one library
holds the shipped entry helib_probes_launch and P2's template on clusters
of 1, 2 and 4 CTAs of 64 threads.  Every P1 variant and every P2 phase is
held bit for bit to p1_plain / p2_plain (which tests/test_torch_probes.py
holds to the TPU probes), alone and over a chain; what only the card can
show (the compiler's output, timing) is left to test_torch_cuda.py and
tools/kernel_times.py."""

import ctypes

import numpy as np
import pytest
import torch

from helib_tpu_torch.ops import ntt as tntt
from helib_tpu_torch.ops import probes
from helib_tpu_torch.ops.modops import shoup, to_device

from test_torch_conv_rows_host import build_host_libs

torch.set_num_threads(1)

# P2's template on clusters of 1, 2 and 4 CTAs of 64 threads, with the
# shipped entry's signature after the probe number.
HARNESS_CU = r"""
#include "probes.cu"

#define P2_ARGS                                                           \
  int phase, const void *x, void *out, long long rows, int log_n,         \
      const void *w, const void *wsh, const void *q, int tab_rows,        \
      void *stream
#define P2_NAMES \
  phase, x, out, rows, log_n, w, wsh, q, tab_rows, \
      static_cast<cudaStream_t>(stream)

extern "C" {
int p2_cluster1(P2_ARGS) { return P2Rows<1, 64, 1>::launch(P2_NAMES); }
int p2_cluster2(P2_ARGS) { return P2Rows<2, 64, 1>::launch(P2_NAMES); }
int p2_cluster4(P2_ARGS) { return P2Rows<4, 64, 1>::launch(P2_NAMES); }
}
"""

P_ = ctypes.c_void_p
P2_ARGTYPES = [ctypes.c_int, P_, P_, ctypes.c_longlong, ctypes.c_int, P_, P_,
               P_, ctypes.c_int, P_]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{C entry name: function}: helib_probes_launch and the harness's."""
    lib = build_host_libs(tmp_path_factory, "probes_host", (),
                          HARNESS_CU)["harness"]
    out = {}
    for entry, argtypes in (("helib_probes_launch", [ctypes.c_int]
                             + P2_ARGTYPES),
                            ("p2_cluster1", P2_ARGTYPES),
                            ("p2_cluster2", P2_ARGTYPES),
                            ("p2_cluster4", P2_ARGTYPES)):
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        out[entry] = fn
    return out


def _run(fn, code, x, w, wsh, q, *probe):
    """One launch of `fn` (with the probe number first for the shipped
    entry) on CPU tensors; returns out."""
    R, n = x.shape
    out = torch.full_like(x, -1)
    err = fn(*probe, code, x.data_ptr(), out.data_ptr(), R,
             n.bit_length() - 1, w.data_ptr(), wsh.data_ptr(), q.data_ptr(),
             w.shape[0], None)
    assert err == 0
    return out


def _p1_args(n, R, seed):
    """Rows on the aux primes (row r on prime r % 3), per-row twiddles."""
    qrow = tntt.aux_primes()[np.arange(R) % 3].astype(np.uint32)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, qrow[:, None].astype(np.int64), (R, n))
    w = rng.integers(1, qrow[:, None].astype(np.int64), (R, n))
    wsh = shoup(w.astype(np.uint32), qrow[:, None].astype(np.uint64))
    return [to_device(a.astype(np.uint32), "cpu")
            for a in (x, w, wsh, qrow[:, None])]


def _p2_args(n, R, seed):
    """Rows on the aux primes (row r on prime r % 3), the flat aux tables."""
    aux = tntt.aux_tree(n, "cpu")["aux"]
    q = aux["q"].reshape(3, 1)
    rng = np.random.default_rng(seed)
    qrow = tntt.aux_primes()[np.arange(R) % 3].astype(np.int64)
    x = rng.integers(0, qrow[:, None], (R, n)).astype(np.uint32)
    return [to_device(x, "cpu"), aux["tw_all"], aux["tw_all_sh"], q]


def _chain(run, x, count):
    for _ in range(count):
        x = run(x)
    return x


@pytest.mark.parametrize("n,R", [(256, 5), (2048, 3)])
@pytest.mark.parametrize("variant", probes.P1_VARIANTS)
def test_p1_source_on_host_matches_plain(libs, variant, n, R):
    """Every P1 variant through the shipped entry, alone and over a chain
    of 2; 5 rows of 256 words (512 for stage_c64, its least N) end inside
    the last CTA for every variant."""
    n = max(n, 512) if variant == "stage_c64" else n
    x, w, wsh, q = _p1_args(n, R, seed=n + R)
    code = probes.P1_VARIANTS.index(variant)
    fn = libs["helib_probes_launch"]
    got = _chain(lambda v: _run(fn, code, v, w, wsh, q, 1), x, 2)
    want = _chain(lambda v: probes.p1_plain(variant, v, w, wsh, q), x, 2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,R", [(128, 4), (256, 3), (2048, 4)])
@pytest.mark.parametrize("phase", probes.P2_PHASES)
def test_p2_source_on_host_matches_plain(libs, phase, n, R):
    """Every P2 phase through the shipped entry (one CTA of 512 threads a
    row): n = 128 (coarse has no stage; fine is one row's whole
    transform), 256 and 2048, 3 tables for 4 rows, alone and chained."""
    x, tw, tw_sh, q = _p2_args(n, R, seed=n + R)
    code = probes.P2_PHASES.index(phase)
    fn = libs["helib_probes_launch"]
    got = _chain(lambda v: _run(fn, code, v, tw, tw_sh, q, 2), x, 2)
    want = _chain(lambda v: probes.p2_plain(phase, v, tw, tw_sh, q), x, 2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [2048, 8192])
@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_p2_template_on_clusters_matches_plain(libs, cluster, n):
    """P2's three phases on clusters of 1, 2 and 4 CTAs of 64 threads:
    coarse's cross composite through the CTAs' shared memory (one local
    composite at n = 2048 on 2 CTAs, two or more at n = 8192), memory and
    fine inside each CTA's part."""
    x, tw, tw_sh, q = _p2_args(n, 2, seed=n + cluster)
    fn = libs[f"p2_cluster{cluster}"]
    for code, phase in enumerate(probes.P2_PHASES):
        assert torch.equal(_run(fn, code, x, tw, tw_sh, q),
                           probes.p2_plain(phase, x, tw, tw_sh, q)), phase


@pytest.mark.slow
def test_p2_source_on_host_at_65536(libs):
    """The shipped n = 65536 configuration: 4-CTA clusters of 256 threads,
    64 KB quarters, every phase."""
    x, tw, tw_sh, q = _p2_args(65536, 1, seed=7)
    fn = libs["helib_probes_launch"]
    for code, phase in enumerate(probes.P2_PHASES):
        assert torch.equal(_run(fn, code, x, tw, tw_sh, q, 2),
                           probes.p2_plain(phase, x, tw, tw_sh, q)), phase


@pytest.mark.parametrize("probe,variant,log_n", [
    (1, 0, 2), (1, 0, 16), (1, 2, 4), (1, 5, 8), (1, 7, 14),
    (2, 0, 6), (2, 1, 17), (2, 3, 14), (3, 0, 14)])
def test_probes_entry_rejects_bad_sizes(libs, probe, variant, log_n):
    """A size out of a variant's range (P1: 2^3 .. 2^15, stage from 2^5,
    stage_c64 from 2^9; P2: 2^7 .. 2^16), an unknown variant or probe is an
    invalid value (1) and launches nothing."""
    assert libs["helib_probes_launch"](probe, variant, None, None, 1, log_n,
                                       None, None, None, 1, None) == 1


@pytest.mark.parametrize("probe,variant,n,msg", [
    (1, "stage_c64", 256, r"\[2\^9, 2\^15\]"),
    (1, "mul", 65536, r"\[2\^3, 2\^15\]"),
    (2, "fine", 131072, r"\[2\^7, 2\^16\]"),
    (2, "coarse", 65536, "CUDA tensor")])
def test_probe_wrappers_check_sizes_first(probe, variant, n, msg):
    """The wrappers refuse what the entry refuses before they look at the
    tensors: n = 65536 passes P2's size check and fails on the CPU
    tensor."""
    x = torch.zeros((1, n), dtype=torch.int32)
    w = torch.zeros((1, n), dtype=torch.int32)
    q = torch.ones((1, 1), dtype=torch.int32)
    run = probes.p1_cuda if probe == 1 else probes.p2_cuda
    with pytest.raises(ValueError, match=msg):
        run(variant, x, w, w, q)
