"""The key-switch readers (`keyswitch_ms_per_op.*`) on a canned
one-at-a-time window: only the device activity launched inside the
program's `Ctxt.relinearize` spans of an operation's requests counts, and
nothing is read without such spans; and a tiny BGV `mult` request records
one key-switch span under its root."""

import pytest

import _tiny
from hebench import cells
from helib_tpu_torch import timing
from test_hebench_program_spans import MS, harness, read, recorded  # noqa: F401

KS = "Ctxt.relinearize"


@pytest.fixture
def fresh_spans():
    """No span recorded before the test, tracing off after it."""
    timing.reset_spans()
    yield
    timing.tracing = False
    timing.reset_spans()


def keyswitch_trace():
    """Two `mult` requests and a `rotate` one (as `harness`), each key
    switch a span of the program, and the device activity of launches
    made inside and outside those spans."""
    t = harness()

    def act(corr, a, b):
        return {"name": f"kernel{corr}", "start": int(a * MS),
                "end": int(b * MS), "corr": corr}
    # (launch time, device start, device end) by correlation id
    made = {10: (1.5, 2, 3), 11: (2.5, 2.5, 3.5), 12: (4.5, 5, 5.5),
            13: (9, 9.5, 10), 14: (10.5, 10.6, 10.8), 15: (15, 15.2, 16)}
    t["launches"] = [{"name": "cudaLaunchKernel", "start": int(a * MS),
                      "end": int(a * MS) + 1000, "corr": c}
                     for c, (a, _, _) in made.items()]
    t["device"] = [act(c, s, e) for c, (_, s, e) in made.items()]
    return t


def keyswitch_program():
    def span(name, a, b, parent, request):
        return {"name": name, "start": int(a * MS), "end": int(b * MS),
                "parent": parent, "request": request}
    return [
        # the first mult: launches 10 and 11 inside its key switch (their
        # activity overlaps: the union is 1.5 ms), 12 after it
        span("Ctxt.multiply", 1, 5, None, 0),
        span(KS, 1.2, 4, 0, 0),
        # the second: launch 14 inside the key switch, 13 before it
        span("Ctxt.multiply", 8.5, 11, None, 2),
        span(KS, 10, 10.9, 2, 2),
        # the rotate: a key switch that launches nothing, then one with 15
        span("Ctxt.smart_automorph", 14.5, 17, None, 4),
        span(KS, 14.6, 14.7, 4, 4),
        span(KS, 14.8, 16, 4, 4),
    ]


def test_keyswitch_reads_only_the_activity_launched_in_its_spans(recorded):
    recorded(keyswitch_program())
    t = keyswitch_trace()
    # mult: 1.5 ms and 0.2 ms over two requests
    assert read("keyswitch_ms_per_op.mult", t) == pytest.approx(0.85)
    assert read("keyswitch_ms_per_op.rotate", t) == pytest.approx(0.8)


def test_keyswitch_reads_nothing_without_its_spans(recorded, monkeypatch):
    names = ("keyswitch_ms_per_op.mult", "keyswitch_ms_per_op.rotate")
    # a program that records spans, but none around its key switches (the
    # port before `Ctxt.relinearize` had one)
    recorded([s for s in keyswitch_program() if s["name"] != KS])
    assert [read(n, keyswitch_trace()) for n in names] == [None, None]
    recorded([])
    assert [read(n, keyswitch_trace()) for n in names] == [None, None]
    monkeypatch.delattr(timing, "spans")
    assert [read(n, keyswitch_trace()) for n in names] == [None, None]


def test_a_tiny_bgv_mult_holds_one_key_switch_span(fresh_spans):
    from hebench import port
    cell = _tiny.cell("bgv", "ops_b1")
    seed = 2 ** 32 + 77
    sch = port.scheme(cell.config, seed, "cpu")
    mix = cells.kind("single")(sch, cell.traffic, seed)
    timing.reset_spans()
    timing.tracing = True
    mix.request("mult", 0, 1, 0, 3)
    spans = timing.spans()
    roots = [i for i, s in enumerate(spans) if s["parent"] is None]
    assert [spans[i]["name"] for i in roots] == ["Ctxt.multiply"]
    (ks,) = [s for s in spans if s["name"] == KS]
    assert ks["parent"] == roots[0]
