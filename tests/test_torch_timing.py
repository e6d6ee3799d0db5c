"""The port's spans (helib_tpu_torch.timing): off without a switch or a
profiler, and then reading no clock; on through `timing.tracing` or under
torch.profiler; the nesting of `parent` and `request` in one thread and in
two; the profiler's clock; and the spans of a BGV and a CKKS multiply at
the port's smallest test contexts (host only)."""

import threading
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from helib_tpu_torch import timing
from helib_tpu_torch.ckks import EncryptedArrayCKKS
from helib_tpu_torch.context import Context
from helib_tpu_torch.keys import PubKey, SecKey, SKHandle


@pytest.fixture
def fresh():
    """No span recorded before the test, tracing off after it."""
    timing.reset_spans()
    yield
    timing.tracing = False
    timing.reset_spans()


def _names(spans):
    return [s["name"] for s in spans]


def _raise(*_):
    raise AssertionError("a clock was read with spans off")


def test_off_records_nothing_and_reads_no_clock(fresh, monkeypatch):
    for clock in ("time_ns", "perf_counter", "perf_counter_ns", "time",
                  "monotonic", "monotonic_ns"):
        monkeypatch.setattr(time, clock, _raise)

    @timing.timed
    def work(x):
        return x + 1
    with timing.timer("outer"):
        assert work(1) == 2
    monkeypatch.undo()
    assert timing.spans() == []
    assert timing.get_timer("outer") == (0, 0.0)


def test_on_through_the_switch_and_under_the_profiler(fresh):
    @timing.timed
    def work():
        with timing.timer("inner"):
            pass
    timing.tracing = True
    work()
    timing.tracing = False
    with profile(activities=[ProfilerActivity.CPU]):
        work()
    work()
    name = work.__qualname__
    assert _names(timing.spans()) == [name, "inner", name, "inner"]
    assert all(s["start"] <= s["end"] for s in timing.spans())


def test_parent_and_request_nest_in_each_thread(fresh):
    timing.tracing = True
    with timing.timer("a"):
        with timing.timer("b"):
            with timing.timer("c"):
                pass
        with timing.timer("d"):
            pass
    with timing.timer("e"):
        pass
    got = [(s["name"], s["parent"], s["request"]) for s in timing.spans()]
    assert got == [("a", None, 0), ("b", 0, 0), ("c", 1, 0), ("d", 0, 0),
                   ("e", None, 4)]

    timing.reset_spans()
    inside, go = threading.Barrier(2, timeout=10), threading.Barrier(
        2, timeout=10)

    def request(tag):
        with timing.timer("root." + tag):
            inside.wait()      # both roots open at once
            with timing.timer("child." + tag):
                go.wait()      # both children open at once

    workers = [threading.Thread(target=request, args=(t,)) for t in "xy"]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=10)
        assert not w.is_alive()
    spans = timing.spans()
    at = {s["name"]: i for i, s in enumerate(spans)}
    for tag in "xy":
        root, child = spans[at["root." + tag]], spans[at["child." + tag]]
        assert root["parent"] is None
        assert root["request"] == at["root." + tag]
        assert child["parent"] == child["request"] == at["root." + tag]


def test_spans_lie_on_the_profilers_clock(fresh):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer_range"):
            time.sleep(0.002)
            with timing.timer("inside"):
                time.sleep(0.001)
            time.sleep(0.002)
    rng = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "outer_range"]
    assert len(rng) == 1
    lo = rng[0].start_ns()
    hi = lo + rng[0].duration_ns()
    (span,) = timing.spans()
    assert lo <= span["start"] < span["end"] <= hi


def test_bgv_multiply_holds_its_measured_mod_downs(fresh):
    ctx = Context(m=45, p=2, r=1, bits=118, c=3, device="cpu")
    sk = SecKey(ctx, seed=3)
    pk = PubKey(sk)
    sk.gen_ks_matrix(SKHandle(2, 1, 0))
    pt = np.zeros(ctx.phi_m, dtype=np.int64)
    pt[0] = 1
    a = pk.encrypt_bgv(pt, np.random.default_rng(5))
    b = pk.encrypt_bgv(pt, np.random.default_rng(6))
    timing.tracing = True
    a.multiply(b, pk)
    spans = timing.spans()
    assert spans[0]["name"] == "Ctxt.multiply"
    assert spans[0]["parent"] is None
    assert all(s["request"] == 0 for s in spans)
    measures = [i for i, s in enumerate(spans)
                if s["name"] == "Ctxt.mod_down_to.measure"]
    assert measures and all(spans[i]["parent"] == 0 for i in measures)
    hosts = [s for s in spans if s["name"] == "Ctxt.mod_down_to.to_host"]
    assert hosts and all(s["parent"] in measures for s in hosts)
    assert set(_names(spans)) == {"Ctxt.multiply", "Ctxt.mod_down_to.measure",
                                  "Ctxt.mod_down_to.to_host",
                                  "Ctxt.relinearize"}


@pytest.fixture(scope="module")
def bgv31():
    """m=31 keys with the relinearization matrix and that of X -> X^3, and
    two fresh encryptions of 1."""
    ctx = Context(m=31, p=2, r=1, bits=120, c=3, device="cpu")
    sk = SecKey(ctx, seed=3)
    pk = PubKey(sk)
    sk.gen_ks_matrix(SKHandle(2, 1, 0))
    sk.gen_ks_matrix(SKHandle(1, 3, 0))
    pt = np.zeros(ctx.phi_m, dtype=np.int64)
    pt[0] = 1
    return pk, [pk.encrypt_bgv(pt, np.random.default_rng(s)) for s in (5, 6)]


def test_key_switches_are_spans_under_their_operation(fresh, bgv31):
    pk, (a, b) = bgv31
    timing.tracing = True
    a.multiply(b, pk)
    spans = timing.spans()
    assert spans[0]["name"] == "Ctxt.multiply"
    (ks,) = [s for s in spans if s["name"] == "Ctxt.relinearize"]
    assert ks["parent"] == ks["request"] == 0
    # smart_automorph: the call that finds the input canonical, then the
    # key switch after X -> X^3
    timing.reset_spans()
    a.copy().smart_automorph(3, pk)
    spans = timing.spans()
    assert spans[0]["name"] == "Ctxt.smart_automorph"
    assert [(s["name"], s["parent"]) for s in spans
            if s["parent"] == 0] == [("Ctxt.relinearize", 0)] * 2
    # off: the same calls record nothing
    timing.tracing = False
    timing.reset_spans()
    a.multiply(b, pk)
    a.copy().smart_automorph(3, pk)
    assert timing.spans() == []


def test_ckks_multiply_measures_no_noise(fresh):
    cc = Context(m=256, p=-1, r=30, bits=240, c=3, scheme="ckks",
                 device="cpu")
    csk = SecKey(cc, seed=3)
    cpk = PubKey(csk)
    csk.gen_ks_matrix(SKHandle(2, 1, 0))
    ea = EncryptedArrayCKKS(cc)
    x = ea.encrypt(np.ones(ea.nslots), cpk, np.random.default_rng(1))
    timing.tracing = True
    ea.rescale(x.multiply(x, cpk))
    roots = [s for s in timing.spans() if s["parent"] is None]
    assert _names(roots) == ["Ctxt.multiply", "EncryptedArrayCKKS.rescale"]
    assert "Ctxt.mod_down_to.measure" not in _names(timing.spans())
