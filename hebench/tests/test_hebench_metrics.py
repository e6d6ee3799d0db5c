"""The per-layer readers and the trace reductions on a small canned trace:
a 10 ms window, NTT-family kernels, ring-op kernels, a copy, and host
spans, all in ns; and a one-at-a-time window of requests."""

import pytest

import _tiny  # noqa: F401
from hebench import cells
from hebench import trace as tr

MS = 1_000_000
K1 = "void ntt_rows_kernel<RowMajor, (Mode)0, 3, 1, 512, 2>(Rows)"


def canned():
    dev = [
        {"name": K1, "start": 1 * MS, "end": 2 * MS, "corr": 1},
        {"name": K1, "start": 2 * MS, "end": 3 * MS, "corr": 1},
        {"name": "elementwise_kernel<mul>", "start": 3 * MS,
         "end": 5 * MS, "corr": 1},
        {"name": "Memcpy DtoD (Device -> Device)", "start": 5 * MS,
         "end": 6 * MS, "corr": 2},
        {"name": "elementwise_kernel<add>", "start": 8 * MS, "end": 9 * MS,
         "corr": 3},
        # outside the window: ignored
        {"name": "elementwise_kernel<add>", "start": 11 * MS,
         "end": 12 * MS, "corr": 4},
    ]
    spans = [{"name": "window", "start": 0, "end": 10 * MS},
             {"name": "request", "start": 0, "end": 10 * MS},
             {"name": "op.mult", "start": 0, "end": 7 * MS},
             {"name": "synchronize", "start": 7 * MS, "end": 10 * MS}]
    return {"device": dev, "spans": spans,
            "window": (0, 10 * MS), "calls": 2, "ops": 32,
            "transform_bound_ms_per_call": 0.25}


def canned_requests(keep: bool = True, skew: int = 0):
    """A one-at-a-time window: two `mult` requests, one `rotate`, and
    between them a `keep` span whose host copy is device activity of its
    own; the card's clock `skew` ns off the host's."""
    dev = [
        # request.mult 0-4 ms: one graph replay (corr 1, two kernels) and
        # an eager kernel (corr 2); busy 1-3 ms
        {"name": K1, "start": 1 * MS, "end": 2 * MS, "corr": 1},
        {"name": "elementwise_kernel<mul>", "start": 2 * MS,
         "end": int(2.5 * MS), "corr": 1},
        {"name": "elementwise_kernel<add>", "start": int(2.5 * MS),
         "end": 3 * MS, "corr": 2},
        # request.rotate 6-7 ms: one kernel, busy 6.2-6.7
        {"name": "elementwise_kernel<add>", "start": int(6.2 * MS),
         "end": int(6.7 * MS), "corr": 3},
        # request.mult 8-10 ms: one replay, busy 8-9
        {"name": K1, "start": 8 * MS, "end": 9 * MS, "corr": 4},
    ]
    launches = [
        {"name": "cudaGraphLaunch", "start": int(0.2 * MS), "corr": 1},
        {"name": "cudaLaunchKernel", "start": int(0.5 * MS), "corr": 2},
        # a synchronize carries an id but causes no device activity
        {"name": "cudaDeviceSynchronize", "start": int(3.5 * MS),
         "corr": 6},
        {"name": "cudaLaunchKernel", "start": int(6.05 * MS), "corr": 3},
        {"name": "cudaGraphLaunch", "start": int(8.01 * MS), "corr": 4},
    ]
    spans = [{"name": "window", "start": 0, "end": 10 * MS},
             {"name": "request.mult", "start": 0, "end": 4 * MS},
             {"name": "op.mult", "start": 0, "end": 3 * MS},
             {"name": "request.rotate", "start": 6 * MS, "end": 7 * MS},
             {"name": "request.mult", "start": 8 * MS, "end": 10 * MS}]
    if keep:
        dev.append({"name": "Memcpy DtoH (Device -> Pageable)",
                    "start": int(4.5 * MS), "end": int(5.5 * MS),
                    "corr": 5})
        launches.append({"name": "cudaMemcpyAsync", "start": int(4.2 * MS),
                         "corr": 5})
        spans.append({"name": "keep", "start": 4 * MS, "end": 6 * MS})
    dev = [{**e, "start": e["start"] + skew, "end": e["end"] + skew}
           for e in dev]
    return {"device": dev, "launches": launches, "spans": spans,
            "window": (0, 10 * MS), "requests": 3}


def read(name, t):
    return cells.reader(name)(t)


def test_readers_on_canned_trace():
    t = canned()
    # ring ops: 2 + 1 ms of non-NTT kernels (the copy is not one) / 32 ops
    assert read("ringops_ms_per_op.b16", t) == pytest.approx(3 / 32)
    # 0.25 ms bound a call x 2 calls over 2 ms of NTT kernels
    assert read("ntt_roofline.b16", t) == pytest.approx(25.0)
    # busy 1..6 and 8..9 ms of 10
    assert read("device_idle_share.b16", t) == pytest.approx(40.0)


def test_per_operation_readers_on_canned_requests():
    t = canned_requests()
    # mult: correlation ids 1, 2, 4 over 2 requests; busy 2 + 1 ms of 6
    assert read("launches_per_op.mult", t) == pytest.approx(1.5)
    assert read("device_idle_share.mult", t) == pytest.approx(50.0)
    # rotate: one launch; busy 0.5 ms of 1
    assert read("launches_per_op.rotate", t) == pytest.approx(1.0)
    assert read("device_idle_share.rotate", t) == pytest.approx(50.0)
    # no rotate request in the window: nothing to read
    t["spans"] = [s for s in t["spans"] if s["name"] != "request.rotate"]
    assert read("launches_per_op.rotate", t) is None
    assert read("device_idle_share.rotate", t) is None


@pytest.mark.parametrize("name", [
    "launches_per_op.mult", "launches_per_op.rotate",
    "device_idle_share.mult", "device_idle_share.rotate"])
def test_keep_and_clock_skew_change_no_per_operation_metric(name):
    """The harness's copy of a kept output to the host (span `keep`, a
    DtoH copy on the card) lies outside every request, and device activity
    is matched to its request by correlation id: no per-operation reader
    sees the copy, nor a skew of the card's clock by 1.5 ms either way."""
    want = read(name, canned_requests(keep=False))
    assert read(name, canned_requests(keep=True)) == want
    for skew in (-int(1.5 * MS), int(1.5 * MS)):
        assert read(name, canned_requests(skew=skew)) == pytest.approx(want)


def test_readers_find_nothing_without_device_activity():
    t = {**canned(), "device": []}
    for name in ("ringops_ms_per_op.b16", "ntt_roofline.b16",
                 "device_idle_share.b16"):
        assert read(name, t) is None
    t = {**canned_requests(), "device": []}
    for op in ("mult", "rotate"):
        assert read("launches_per_op." + op, t) is None
        assert read("device_idle_share." + op, t) is None


def test_busy_and_breakdown():
    t = canned()
    assert tr.busy_ns(t["device"], 0, 10 * MS) == 6 * MS
    b = tr.breakdown(t, 0, 10 * MS)
    assert b["device_ops"][0] == [K1, 0.002]
    # idle 0-1 ms inside op.mult; 6-8 ms (labelled at its middle, 7 ms)
    # and 9-10 ms in synchronize
    assert dict(b["idle_gaps"]) == {"op.mult": pytest.approx(0.001),
                                    "synchronize": pytest.approx(0.003)}
    assert tr.window_of(t) == (0, 10 * MS)


def test_every_per_layer_metric_has_a_reader():
    for m in _tiny.bench()["per_layer"]:
        assert callable(cells.reader(m["name"]))
