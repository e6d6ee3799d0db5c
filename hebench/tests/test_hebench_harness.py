"""The harness end to end on tiny rings on the CPU, and `correct` coming
out false when the timed path is broken underneath it: a step that
returns its state unchanged, half of the batch left out, an answer altered
where it is produced, and the control (the ring's products in float64).
The look for a card is main()'s; run_cell skips it."""

import contextlib

import pytest
import torch

import _tiny
from hebench import cells, control, run

SEED = 2 ** 32 + 77


def run_tiny(scheme, traffic, trace=False):
    torch.set_num_threads(1)
    return run.run_cell(_tiny.cell(scheme, traffic), SEED, 0.5, trace,
                        device="cpu", t_start=0.0)


@pytest.mark.parametrize("scheme", ["bgv", "ckks"])
@pytest.mark.parametrize("traffic", ["mult_b16", "ops_b1"])
def test_cell_end_to_end(scheme, traffic):
    r = run_tiny(scheme, traffic)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    cell = _tiny.cell(scheme, traffic)
    assert [*r["metrics"]] == [m["name"] for m in cell.end_to_end]
    assert list(r)[-1] == "compared"
    for name, v in r["compared"].items():
        assert v["value"] <= v["limit"] == cell.limits[name]


@pytest.mark.parametrize("traffic", ["mult_b16", "ops_b1"])
def test_traced_run(traffic):
    r = run_tiny("bgv", traffic, trace=True)
    assert r["correct"]
    # no device activity on the CPU: every reader finds nothing
    assert r["metrics"] == {} and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@contextlib.contextmanager
def patched(obj, name, fn):
    orig = getattr(obj, name)
    setattr(obj, name, fn(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def unchanged(orig):
    """The product returns its first operand untouched."""
    def mult_relin(ctx, pk, key, noise, k, c0_0, c0_1, c1_0, c1_1,
                   shard=None):
        out = orig(ctx, pk, key, noise, k, c0_0, c0_1, c1_0, c1_1, shard)
        out.parts = [(h, d) for (h, _), d in zip(out.parts, (c0_0, c0_1))]
        return out
    return mult_relin


def half_batch(orig):
    """Only the first half of the batch is computed; the rest is left as
    it came in."""
    def mult_relin(ctx, pk, key, noise, k, c0_0, c0_1, c1_0, c1_1,
                   shard=None):
        h = c0_0.shape[0] // 2
        out = orig(ctx, pk, key, noise, k, c0_0, c0_1, c1_0, c1_1, shard)
        out.parts = [(hd, torch.cat([d[:h], c[h:]]))
                     for (hd, d), c in zip(out.parts, (c0_0, c0_1))]
        return out
    return mult_relin


def altered(orig):
    """One residue of every output changed where it is produced."""
    def mult_relin(*a, **kw):
        out = orig(*a, **kw)
        h, d = out.parts[0]
        d = d.clone()
        d[..., 0, 5] = (d[..., 0, 5] + 1) % int(out.ctx.qs[0])
        out.parts[0] = (h, d)
        return out
    return mult_relin


def unreduced(orig):
    """Every residue of the output left at its value plus its prime (a
    lazy reduction not finished): decrypts right, but is out of range."""
    def mult_relin(*a, **kw):
        out = orig(*a, **kw)
        q = torch.from_numpy(out.ctx.qs.astype("int64"))[:, None]
        out.parts = [(h, (d.to(torch.int64) + q).to(torch.int32))
                     for h, d in out.parts]
        return out
    return mult_relin


@pytest.mark.parametrize("scheme", ["bgv", "ckks"])
@pytest.mark.parametrize("fault", [unchanged, half_batch, altered,
                                   unreduced])
def test_batched_faults_are_not_correct(scheme, fault):
    from helib_tpu_torch import pipeline
    with patched(pipeline, "mult_relin", fault):
        assert not run_tiny(scheme, "mult_b16")["correct"]


def op_unchanged(orig):
    return lambda sch, a, b, const, amt: a.copy()


def op_altered(orig):
    """One residue of part 1 changed, at the value at w^1 (a primitive
    root at any m: a value at another root can lie outside Phi_m)."""
    def run(sch, a, b, const, amt):
        out = orig(sch, a, b, const, amt)
        h, d = out.parts[1]
        out.parts[1] = (h, torch.where(
            torch.arange(d.shape[-1]) == 1, (d + 1) % int(out.ctx.qs[0]), d))
        return out
    return run


@pytest.mark.parametrize("scheme", ["bgv", "ckks"])
@pytest.mark.parametrize("fault", [op_unchanged, op_altered])
def test_single_faults_are_not_correct(scheme, fault):
    with contextlib.ExitStack() as st:
        for op in ("mult", "rotate", "mul_plain", "add"):
            st.enter_context(patched(cells.op(scheme, op), "run", fault))
        assert not run_tiny(scheme, "ops_b1")["correct"]


@pytest.mark.parametrize("scheme", ["bgv", "ckks"])
@pytest.mark.parametrize("traffic", ["mult_b16", "ops_b1"])
def test_control_is_not_correct(scheme, traffic):
    with control.float64_products():
        r = run_tiny(scheme, traffic)
    assert not r["correct"]
    assert any(v["value"] > v["limit"] for v in r["compared"].values())


OTHER_BGV = {
    "p17_r2": {"scheme": "bgv", "m": 127, "p": 17, "r": 2, "bits": 150,
               "c": 3, "rotations": [3]},
    "pow2_m128": {"scheme": "bgv", "m": 128, "p": 257, "r": 1, "bits": 150,
                  "c": 3, "rotations": [5]},
    "m105_r3": {"scheme": "bgv", "m": 105, "p": 2, "r": 3, "bits": 150,
                "c": 3, "rotations": [2]},
}


def run_other(name, traffic):
    torch.set_num_threads(1)
    cell = _tiny.cell("bgv", traffic)
    cell.config = OTHER_BGV[name]
    return run.run_cell(cell, SEED, 0.5, False, device="cpu", t_start=0.0)


@pytest.mark.parametrize("name", sorted(OTHER_BGV))
@pytest.mark.parametrize("traffic", ["mult_b16", "ops_b1"])
def test_bgv_at_other_plaintext_moduli_and_rings(name, traffic):
    """A configuration file alone brings BGV at p^r > 2, at power-of-2 m
    and at composite m: the reference divides out the plaintext factor
    each output states and reduces mod Phi_m."""
    assert run_other(name, traffic)["correct"]


@pytest.mark.parametrize("name", sorted(OTHER_BGV))
def test_bgv_at_other_moduli_sees_an_altered_answer(name):
    with contextlib.ExitStack() as st:
        for op in ("mult", "rotate", "mul_plain", "add"):
            st.enter_context(patched(cells.op("bgv", op), "run", op_altered))
        assert not run_other(name, "ops_b1")["correct"]


def test_cell_on_the_card():
    """One short run of a tiny cell on the card, judged by the reference."""
    pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = run.run_cell(_tiny.cell("bgv", "mult_b16"), SEED, 0.5, False,
                     device="cuda", t_start=0.0)
    assert r["correct"] and r["device"]["platform"] == "gpu"


test_cell_on_the_card = pytest.mark.cuda(test_cell_on_the_card)
