"""Port vs helib_tpu: the infra modules -- security (lwe_estimate_security,
context_security, find_m), Context.printout, argmap, the timers, the
exception helpers and debugging.PtSim on a MatMul1D at m=31."""

import io
import time

import numpy as np
import pytest
import torch

from helib_tpu import security as jsec
from helib_tpu import exceptions as jexc
from helib_tpu.context import Context as JContext
from helib_tpu.ea import EncryptedArray as JEA
from helib_tpu.algos.matmul import MatMul1D as JMatMul1D
from helib_tpu.debugging import PtSim as JPtSim

import helib_tpu_torch
from helib_tpu_torch import security, exceptions, timing, log
from helib_tpu_torch.argmap import ArgMap, ArgMapError
from helib_tpu_torch.context import Context as TContext, build_context
from helib_tpu_torch.ea import EncryptedArray as TEA
from helib_tpu_torch.algos.matmul import MatMul1D
from helib_tpu_torch.debugging import PtSim

torch.set_num_threads(1)

CONTEXTS = [dict(m=45, p=2, r=1, bits=240, c=3),
            dict(m=31, p=2, r=1, bits=300, c=3),
            dict(m=4095, p=2, r=1, bits=500, c=2, mvec=(7, 5, 9, 13)),
            dict(m=256, p=-1, r=20, bits=240, c=3, scheme="ckks")]


@pytest.mark.parametrize("n,log2_alpha_inv,hwt", [
    (4096, 100, 0), (16384, 400, 0), (8190, 300, 120), (32002, 600, 150),
    (1200, 60, 64), (65536, 1000, 450)])
def test_lwe_estimate_security_equals_helib_tpu(n, log2_alpha_inv, hwt):
    assert (security.lwe_estimate_security(n, log2_alpha_inv, hwt)
            == jsec.lwe_estimate_security(n, log2_alpha_inv, hwt))


@pytest.mark.parametrize("params", CONTEXTS[:3])
def test_context_security_and_find_m_equal_helib_tpu(params):
    tc, jc = TContext(**params, device="cpu"), JContext(**params)
    for hwt in (0, 120, 64):
        assert (security.context_security(tc, hwt)
                == jsec.context_security(jc, hwt))
    p, nbits = max(params["p"], 0), params["bits"]
    for k, d in ((80, 0), (128, 0), (80, 16), (10 ** 6, 0)):
        got = _outcome(security.find_m, k, nbits, p, d)
        assert got == _outcome(jsec.find_m, k, nbits, p, d), (k, d)


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("params", [CONTEXTS[0], CONTEXTS[1], CONTEXTS[3]])
def test_printout_equals_helib_tpu(params):
    outs = []
    for ctx in (build_context(**params, device="cpu"), JContext(**params)):
        buf = io.StringIO()
        ctx.printout(buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "security ~=" in outs[0]


def test_argmap():
    """tests/test_extras.py::test_argmap on the port."""
    am = (ArgMap().arg("m", 45, "cyclotomic").arg("p", 2).required()
          .toggle("verbose"))
    assert am.parse(["m=31", "p", "5", "verbose"]) == {
        "m": 31, "p": 5, "verbose": True}
    with pytest.raises(ArgMapError):
        am.parse(["m=31"])
    with pytest.raises(ArgMapError):
        am.parse(["bogus=1", "p=2"])


def test_argmap_parse_file(tmp_path):
    path = tmp_path / "params"
    path.write_text("m 31  # cyclotomic\np=5\n\nverbose\n")
    am = ArgMap().arg("m", 45).arg("p", 2).toggle("verbose")
    assert am.parse_file(str(path)) == {"m": 31, "p": 5, "verbose": True}


def test_timers_count_and_accumulate():
    timing.reset_all_timers()
    for _ in range(3):
        with timing.timer("step"):
            time.sleep(0.002)

    @timing.timed
    def work():
        return 7
    assert work() == 7 and work() == 7
    count, total = timing.get_timer("step")
    assert count == 3 and total >= 0.006
    assert timing.get_timer(work.__name__) == (0, 0.0)
    assert timing.get_timer("test_timers_count_and_accumulate.<locals>."
                            "work")[0] == 2
    buf = io.StringIO()
    timing.print_all_timers(buf)
    assert buf.getvalue().splitlines()[0].startswith("  step: ")
    timing.reset_all_timers()
    assert timing.get_timer("step") == (0, 0.0)


def test_exception_helpers_raise_the_same_types():
    for mod in (exceptions, jexc):
        mod.assert_eq(1, 1, "eq")
        mod.assert_neq(1, 2, "neq")
        mod.assert_in_range(3, 0, 4, "range")
    cases = [("assert_eq", (1, 2, "eq"), "LogicError"),
             ("assert_neq", (1, 1, "neq"), "LogicError"),
             ("assert_in_range", (4, 0, 4, "range"), "OutOfRangeError")]
    for fn, args, exc in cases:
        for mod in (exceptions, jexc):
            with pytest.raises(getattr(mod, exc)) as err:
                getattr(mod, fn)(*args)
            assert isinstance(err.value, mod.HelibError)
        assert (str(pytest.raises(getattr(exceptions, exc),
                                  getattr(exceptions, fn), *args).value)
                == str(pytest.raises(getattr(jexc, exc), getattr(jexc, fn),
                                     *args).value))
    assert issubclass(exceptions.RuntimeFailure, exceptions.HelibError)
    assert not issubclass(exceptions.RuntimeFailure, RuntimeError)


def test_log_file_and_package_reexports():
    buf = io.StringIO()
    log.set_log_file(buf)
    try:
        log.helog("hello")
        log.warning("careful")
    finally:
        log.set_log_file(__import__("sys").stderr)
    assert buf.getvalue() == ("[helib_tpu_torch] hello\n"
                              "[helib_tpu_torch] WARNING: careful\n")
    import helib_tpu
    for name, args in (("factorize", (4095,)), ("phi_n", (4095,)),
                       ("mult_order", (2, 4095)),
                       ("find_generators", (31, 2))):
        assert (getattr(helib_tpu_torch, name)(*args)
                == getattr(helib_tpu, name)(*args)), name


def test_ptsim_matmul1d_equals_helib_tpu():
    """One MatMul1D (6 x 6 over GF(2^5) at m=31) applied to a PtSim in both
    packages: the same polynomial."""
    params = dict(m=31, p=2, r=1, bits=120, c=2)
    tea, jea = TEA(TContext(**params, device="cpu")), JEA(JContext(**params))
    rng = np.random.default_rng(311)
    M = rng.integers(0, 2, (6, 6, tea.d))
    v = rng.integers(0, 2, (tea.nslots, tea.d))
    get = lambda i, j: M[i, j]
    out = MatMul1D(tea, 0, get).apply(PtSim(tea.encode(list(v)), tea), None)
    ref = JMatMul1D(jea, 0, get).apply(JPtSim(jea.encode(list(v)), jea), None)
    np.testing.assert_array_equal(out.poly, ref.poly)
    assert out.poly.any()
