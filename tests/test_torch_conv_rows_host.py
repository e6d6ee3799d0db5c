"""K1 and K3's CUDA sources (ops/csrc/conv.cu, conv_aux.cu and their device
template ntt_rows.cuh) run on the host: compiled by g++ against a small
stand-in for the CUDA runtime and cooperative groups (below), each CTA's
threads as std::threads, __syncthreads() and cluster.sync() as
std::barriers, a cluster's distributed shared memory as its CTAs' buffers.
Their C entries are called with CPU tensors and held bit for bit to
conv_plain / conv_aux_plain: the shipped entries, and the template under
other configurations (threads a CTA, a 2-CTA cluster) through the test's own
entries (HARNESS_CU).  The kernels' lazy arithmetic, schedule, row
maps and cluster offsets are exercised as the card runs them; what only
the card can show (the compiler's output, timing) is left to
test_torch_cuda.py and tools/kernel_times.py."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from helib_tpu_torch.ops import ntt as tntt
from helib_tpu_torch.ops._build import CSRC
from helib_tpu_torch.ops.conv import conv_plain, conv_aux_plain
from helib_tpu_torch.ops.modops import shoup, to_device

torch.set_num_threads(1)

CUDA_RUNTIME_H = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
inline uint2 make_uint2(uint32_t x, uint32_t y) { return {x, y}; }
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return {x, y, z, w};
}
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

namespace stub {
struct Cta {
  std::vector<uint32_t> smem;
  std::unique_ptr<std::barrier<>> bar;
};
struct Ctx {
  std::vector<Cta>* cluster;
  unsigned rank;
  std::barrier<>* cbar;
};
inline thread_local Ctx ctx;
inline uint32_t* smem() { return (*ctx.cluster)[ctx.rank].smem.data(); }
}  // namespace stub

inline thread_local dim3 threadIdx, blockIdx, blockDim;

inline void __syncthreads() {
  (*stub::ctx.cluster)[stub::ctx.rank].bar->arrive_and_wait();
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned long long __umul64hi(unsigned long long a,
                                     unsigned long long b) {
  return static_cast<unsigned long long>(
      (static_cast<unsigned __int128>(a) * b) >> 64);
}
// the host compiles without -mfma and with ISO C++'s -ffp-contract=off, so
// each product and sum is rounded on its own, as these intrinsics are
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline long long __double_as_longlong(double d) {
  long long v;
  std::memcpy(&v, &d, sizeof v);
  return v;
}
inline unsigned long long atomicMax(unsigned long long* p,
                                    unsigned long long v) {
  std::atomic_ref<unsigned long long> a(*p);
  unsigned long long old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute,
                                                    int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "invalid value" : "no error";
}

// Runs the grid cluster by cluster, every thread of a cluster at once.
template <class... K, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kern)(K...), A... args) {
  unsigned C = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      C = cfg->attrs[i].val.clusterDim.x;
  const unsigned T = cfg->blockDim.x;
  if (cfg->gridDim.x % C) return cudaErrorInvalidValue;
  for (unsigned c0 = 0; c0 < cfg->gridDim.x; c0 += C) {
    std::vector<stub::Cta> ctas(C);
    for (auto& cta : ctas) {
      cta.smem.assign(cfg->dynamicSmemBytes / 4, 0xdeadbeefu);
      cta.bar = std::make_unique<std::barrier<>>(T);
    }
    std::barrier<> cbar(C * T);
    std::vector<std::thread> threads;
    for (unsigned r = 0; r < C; ++r)
      for (unsigned t = 0; t < T; ++t)
        threads.emplace_back([&, r, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(c0 + r);
          blockDim = cfg->blockDim;
          stub::ctx = {&ctas, r, &cbar};
          kern(args...);
        });
    for (auto& th : threads) th.join();
  }
  return cudaSuccess;
}
"""

COOPERATIVE_GROUPS_H = r"""
#pragma once
#include <cuda_runtime.h>
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return stub::ctx.rank; }
  void sync() const { stub::ctx.cbar->arrive_and_wait(); }
  template <class T> T* map_shared_rank(T* p, unsigned r) const {
    const auto off = reinterpret_cast<uint32_t*>(p) - stub::smem();
    return reinterpret_cast<T*>((*stub::ctx.cluster)[r].smem.data() + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
"""

# the one line of device code the stand-in cannot take as it is
SHARED_DECL = "extern __shared__ uint32_t s[];"

# Entries of the template under configurations the sources do not ship,
# with helib_conv_launch's signature: one CTA a row below n = 65536, a
# cluster a row at n = 65536.
HARNESS_CU = r"""
#include "ntt_rows.cuh"

#define CONV_ARGS                                                         \
  const void *x, void *out, long long rows, int log_n, int P,             \
      const void *tw, const void *tw_sh, const void *itw,                 \
      const void *itw_sh, const void *khat, const void *khat_sh,          \
      const void *aux_q, void *stream
#define CONV_NAMES \
  x, out, rows, log_n, P, tw, tw_sh, itw, itw_sh, khat, khat_sh, aux_q

template <class Map, int kThreads, int kCluster, int kClusterThreads>
int run(CONV_ARGS) {
  const auto s = static_cast<cudaStream_t>(stream);
  using helib::kConv, helib::kMaxK;
  if (log_n == 16)
    return helib::Rows<Map, kConv, kMaxK, kCluster, kClusterThreads,
                       1>::launch(CONV_NAMES, s);
  return helib::Rows<Map, kConv, kMaxK, 1, kThreads, 1>::launch(CONV_NAMES,
                                                                s);
}

extern "C" {
int conv_threads64(CONV_ARGS) {
  return run<helib::RowMajor, 64, 4, 64>(CONV_NAMES, stream);
}
int conv_aux_threads64(CONV_ARGS) {
  return run<helib::AuxMajor, 64, 4, 64>(CONV_NAMES, stream);
}
int conv_aux_cluster2(CONV_ARGS) {
  return run<helib::AuxMajor, helib::kRowThreads, 2, 128>(CONV_NAMES,
                                                          stream);
}
int conv_aux_cluster2_wide(CONV_ARGS) {
  return run<helib::AuxMajor, helib::kRowThreads, 2, 1024>(CONV_NAMES,
                                                           stream);
}
}
"""

# (source, label) -> (library, C entry)
ENTRIES = {
    ("conv", "shipped"): ("conv", "helib_conv_launch"),
    ("conv", "threads64"): ("harness", "conv_threads64"),
    ("conv_aux", "shipped"): ("conv_aux", "helib_conv_aux_launch"),
    ("conv_aux", "threads64"): ("harness", "conv_aux_threads64"),
    ("conv_aux", "cluster2"): ("harness", "conv_aux_cluster2"),
    ("conv_aux", "cluster2_wide"): ("harness", "conv_aux_cluster2_wide"),
}

PROBE_CC = "#include <barrier>\n#include <thread>\nint main() {}\n"


def _gxx(gxx, inc, src, out, *extra):
    return [gxx, "-std=c++20", "-O1", "-pthread", "-w", "-I", str(inc),
            *extra, "-x", "c++", str(src), "-o", str(out)]


def build_host_libs(tmp_path_factory, label: str, names, harness: str):
    """Builds ops/csrc/<name>.cu for each of `names` and the test's own
    harness source (which includes the csrc headers) with g++ against the
    stand-in runtime, one g++ per source, all started together; returns
    {name: ctypes.CDLL} with the harness as "harness".  Skips without a g++
    that has C++20's <barrier> and <thread>."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the kernel sources")
    root = tmp_path_factory.mktemp(label)
    probe = root / "probe.cc"
    probe.write_text(PROBE_CC)
    if subprocess.run(_gxx(gxx, root, probe, root / "probe"),
                      capture_output=True).returncode != 0:
        pytest.skip("needs a g++ with C++20's <barrier> and <thread>")
    inc = root / "include"
    inc.mkdir()
    (inc / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (inc / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS_H)
    src = root / "src"
    src.mkdir()
    for name in os.listdir(CSRC):
        text = open(os.path.join(CSRC, name)).read()
        if name == "ntt_rows.cuh":
            assert text.count(SHARED_DECL) == 1
        text = text.replace(SHARED_DECL, "uint32_t* s = stub::smem();")
        (src / name).write_text(text)
    (src / "harness.cu").write_text(harness)
    jobs = {}
    for name in (*names, "harness"):
        so = root / f"lib{name}.so"
        jobs[name] = (so, subprocess.Popen(
            _gxx(gxx, inc, src / f"{name}.cu", so, "-shared", "-fPIC"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"g++ {name}.cu:\n{log}"
        built[name] = ctypes.CDLL(str(so))
    return built


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{(source, label): the C entry of the library g++ built}."""
    built = build_host_libs(tmp_path_factory, "conv_rows_host",
                            ("conv", "conv_aux"), HARNESS_CU)
    out = {}
    for key, (name, entry) in ENTRIES.items():
        fn = getattr(built[name], entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [
            ctypes.c_void_p] * 8
        out[key] = fn
    return out


def _args(n, P, lead, seed, aux_major):
    raux = tntt.aux_primes().astype(np.int64)
    rng = np.random.default_rng(seed)
    shape = lead + (3, P, n)
    x = rng.integers(0, raux[:, None, None], shape).astype(np.uint32)
    kh = rng.integers(0, raux[:, None, None], (3, P, n)).astype(np.uint32)
    khsh = shoup(kh, raux[:, None, None].astype(np.uint64))
    x = to_device(x, "cpu")
    if aux_major:
        x = x.movedim(len(lead), 0).contiguous()
    return (x, tntt.aux_tree(n, "cpu")["aux"], to_device(kh, "cpu"),
            to_device(khsh, "cpu"))


def _run(fn, x, aux, kh, khsh):
    n, P = x.shape[-1], x.shape[-2]
    out = torch.full_like(x, -1)
    ptr = [t.data_ptr() for t in (aux["tw_all"], aux["tw_all_sh"],
                                  aux["itw_all"], aux["itw_all_sh"], kh, khsh,
                                  aux["q"])]
    err = fn(x.data_ptr(), out.data_ptr(), x.numel() // n,
             n.bit_length() - 1, P, *ptr, None)
    assert err == 0
    return out


@pytest.mark.parametrize("label", ["shipped", "threads64"])
@pytest.mark.parametrize("n,P,lead", [(8, 2, (2,)), (64, 3, (2,)),
                                      (2048, 5, ()), (32768, 1, ())])
def test_conv_source_on_host_matches_plain(libs, label, n, P, lead):
    """K1 (row-major, one CTA a row): odd P, a lead dim, n = 8 (one
    composite: x in, out back) to 32768 (five a direction)."""
    args = _args(n, P, lead, seed=n + P, aux_major=False)
    assert torch.equal(_run(libs["conv", label], *args), conv_plain(*args))


@pytest.mark.parametrize("label", ["shipped", "threads64", "cluster2",
                                   "cluster2_wide"])
@pytest.mark.parametrize("n,P,lead", [(256, 3, (2,)), (65536, 1, ())])
def test_conv_aux_source_on_host_matches_plain(libs, label, n, P, lead):
    """K3 (aux-major): one CTA a row at n = 256, the cluster at n = 65536
    (4 CTAs shipped; 64 threads a CTA, and 2-CTA clusters of 128 and of
    1024 threads)."""
    args = _args(n, P, lead, seed=n + P + 1, aux_major=True)
    assert torch.equal(_run(libs["conv_aux", label], *args),
                       conv_aux_plain(*args))


@pytest.mark.parametrize("entry,n,rows", [("shipped", 256, 4),
                                          ("shipped", 4, 3),
                                          ("shipped", 131072, 3)])
def test_conv_aux_entry_rejects_bad_shapes(libs, entry, n, rows):
    """A row count that is not a multiple of 3, or a size outside
    [2^3, 2^16], is an invalid value (1) and launches nothing."""
    null = [None] * 7
    assert libs["conv_aux", entry](None, None, rows, n.bit_length() - 1, 1,
                                   *null, None) == 1
