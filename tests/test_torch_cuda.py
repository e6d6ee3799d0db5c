"""The port's CUDA kernels and its main path on the card, against the plain
torch versions.

Every test needs an NVIDIA GPU and skips without one.  The file imports no
JAX, so it also runs where only PyTorch is installed (the conftest, which
imports JAX, is left out):

    python -m pytest --noconftest -o addopts= -p no:cacheprovider \
        tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from helib_tpu_torch.context import Context
from helib_tpu_torch.keys import SecKey
from helib_tpu_torch.ops import ntt
from helib_tpu_torch.ops.conv import conv, conv_cuda, conv_plain
from helib_tpu_torch.ops.modops import shoup, to_device
from helib_tpu_torch.pipeline import make_batched_mult_relin

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _conv_args(n, P, seed, dev):
    raux = ntt.aux_primes().astype(np.int64)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, raux[:, None, None], (2, 3, P, n)).astype(np.uint32)
    kh = rng.integers(0, raux[:, None, None], (3, P, n)).astype(np.uint32)
    khsh = shoup(kh, raux[:, None, None].astype(np.uint64))
    return (to_device(x, dev), ntt.aux_tree(n, dev)["aux"],
            to_device(kh, dev), to_device(khsh, dev))


@pytest.mark.parametrize("n", [8, 64, 2048, 16384, 32768])
def test_conv_kernel_matches_plain_on_gpu(gpu, n):
    args = _conv_args(n, 5, seed=n, dev=gpu)
    before = conv_cuda.launches
    got = conv(*args)
    torch.cuda.synchronize()
    assert conv_cuda.launches == before + 1
    assert torch.equal(got, conv_plain(*args))


@pytest.mark.parametrize("n", [48, 4, 65536])
def test_conv_kernel_refuses_unsupported_lengths(gpu, n):
    x = torch.zeros((1, 3, 2, n), dtype=torch.int32, device=gpu)
    before = conv_cuda.launches
    with pytest.raises(ValueError, match="power of two"):
        conv_cuda(x, {}, None, None)
    assert conv_cuda.launches == before


def test_batched_mult_relin_on_gpu_equals_cpu_port(gpu):
    params = dict(m=31, p=2, r=1, bits=300, c=3)
    ctx, ctx_cpu = Context(**params), Context(**params, device="cpu")
    assert ctx.device.type == "cuda"
    fn, args = make_batched_mult_relin(ctx, SecKey(ctx, seed=3), 2)
    fn_cpu, _ = make_batched_mult_relin(ctx_cpu, SecKey(ctx_cpu, seed=3), 2)
    before = conv_cuda.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert conv_cuda.launches - before == 8
    want = fn_cpu(*[a.cpu() for a in args])
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)
