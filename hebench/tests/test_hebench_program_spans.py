"""The readers of the program's own spans (helib_tpu_torch.timing) on a
canned one-at-a-time window: which request a span tree belongs to (the
request that holds its outermost span's midpoint, also when that span
straddles two requests), the subtractions of noise and dispatch, and
nothing to read without requests, device activity or the program's
recorder."""

import pytest

import _tiny  # noqa: F401
from hebench import cells
from helib_tpu_torch import timing

MS = 1_000_000
MEASURE, TO_HOST = "Ctxt.mod_down_to.measure", "Ctxt.mod_down_to.to_host"


def harness():
    """Two `mult` requests and a `rotate` one straight after the second."""
    spans = [{"name": "window", "start": 0, "end": 20 * MS},
             {"name": "request.mult", "start": 0, "end": 6 * MS},
             {"name": "request.mult", "start": 8 * MS, "end": 14 * MS},
             {"name": "request.rotate", "start": 14 * MS, "end": 20 * MS}]
    dev = [{"name": "elementwise_kernel<mul>", "start": 3 * MS,
            "end": 4 * MS, "corr": 1}]
    return {"device": dev, "launches": [], "spans": spans,
            "window": (0, 20 * MS), "requests": 3}


def program(offset: int = 0):
    """The program's spans, in opening order, `offset` ns off the
    profiler's clock."""
    def span(name, a, b, parent, request):
        return {"name": name, "start": int(a * MS) + offset,
                "end": None if b is None else int(b * MS) + offset,
                "parent": parent, "request": request}
    return [
        # the first mult: measure 2 ms, of it 0.75 ms copies to the host
        span("Ctxt.multiply", 1, 5, None, 0),
        span(MEASURE, 2, 4, 0, 0),
        span(TO_HOST, 2, 2.5, 1, 0),
        span(TO_HOST, 3, 3.25, 1, 0),
        # the second: two outermost spans, a measure and an encode
        span("Ctxt.multiply", 8.5, 11, None, 4),
        span(MEASURE, 9, 10, 4, 4),
        span(TO_HOST, 9, 9.5, 5, 4),
        span("EncryptedArrayCKKS.rescale", 11, 12, None, 7),
        span("EncryptedArrayCKKS.encode", 11.25, 12, 7, 7),
        # the rotate's span opens inside the second mult's request; its
        # midpoint, 15 ms, lies in the rotate's
        span("Ctxt.smart_automorph", 13.5, 16.5, None, 9),
        span("jitutil.replay", 13.6, 13.8, 9, 9),
        # still open, and outside the window: not read
        span("Ctxt.add", 19, None, None, 11),
        span("Ctxt.add", 25, 26, None, 12),
    ]


def read(name, t):
    return cells.reader(name)(t)


@pytest.fixture
def recorded(monkeypatch):
    def use(spans):
        monkeypatch.setattr(timing, "spans", lambda: spans)
    return use


@pytest.mark.parametrize("offset", [0, -20_000, 20_000])
def test_program_spans_split_each_request(recorded, offset):
    recorded(program(offset))
    t = harness()
    # noise: (2 - 0.75) and (1 - 0.5) ms over two requests
    assert read("noise_ms_per_op.mult", t) == pytest.approx(0.875)
    # dispatch: (4 - 2) and (3.5 - 1 - 0.75) ms over two requests
    assert read("dispatch_ms_per_op.mult", t) == pytest.approx(1.875)
    # the straddling span and its replay are the rotate's alone
    assert read("dispatch_ms_per_op.rotate", t) == pytest.approx(3.0)


def test_a_root_goes_whole_to_the_request_of_its_midpoint(recorded):
    spans = program()
    recorded(spans)
    got = cells._module("metrics", "dispatch_ms_per_op.mult"
                        ).program_requests(harness(), "rotate")
    assert {k: [s["name"] for s in tree] for k, tree in got.items()} == {
        0: ["Ctxt.smart_automorph", "jitutil.replay"]}
    # moved to end in the gap between the mult requests, the first mult's
    # span has its midpoint outside both: that tree is read nowhere
    spans[0] = {**spans[0], "end": 12 * MS}
    mult = cells._module("metrics", "dispatch_ms_per_op.mult"
                         ).program_requests(harness(), "mult")
    assert list(mult) == [1] and mult[1][0]["index"] == 4


def test_nothing_to_read_without_requests_device_or_recorder(recorded,
                                                             monkeypatch):
    names = ("noise_ms_per_op.mult", "dispatch_ms_per_op.mult",
             "dispatch_ms_per_op.rotate")
    recorded(program())
    t = harness()
    t["spans"] = [s for s in t["spans"] if s["name"] == "window"]
    assert [read(n, t) for n in names] == [None, None, None]
    # a run on the host CPU: no device trace
    assert [read(n, {**harness(), "device": []}) for n in names] == [
        None, None, None]
    recorded([])
    assert [read(n, harness()) for n in names] == [None, None, None]
    # a program without the recorder (an older helib_tpu_torch.timing)
    monkeypatch.delattr(timing, "spans")
    assert [read(n, harness()) for n in names] == [None, None, None]
