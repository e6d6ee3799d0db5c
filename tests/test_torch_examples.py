"""The port's twins of examples/01-10 (helib_tpu_torch/examples/).

Every tutorial in examples/ has a twin of the same name.  The twins of 01
and 02 run in-process on the CPU here; the `slow` cases run each twin and
its JAX example as subprocesses and compare the lines that carry decrypted
values: BGV lines exactly, CKKS numbers to the digits the example prints
(one unit in the last printed place) or within 1e-2 where it prints a
float's full repr.
"""

import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = sorted((REPO / "examples").glob("*.py"))
TWINS = REPO / "helib_tpu_torch" / "examples"
NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")

# examples/04_ckks_depth.py fails its own assertion at level 1 (released
# error 0.495 > errorBound 0.492): it holds the error released by the
# decrypt's Li-Micciancio mitigation, sized to add up to the bound again,
# to the bound.  Its twin asserts the bound on the pre-mitigation error.
REFERENCE_FAILS = {"04_ckks_depth": "error bound violated"}


def load_twin(name: str):
    spec = importlib.util.spec_from_file_location(f"twin_{name}",
                                                  TWINS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_example_has_a_twin():
    assert len(EXAMPLES) == 10
    assert sorted(p.name for p in TWINS.glob("*.py")) == \
        [p.name for p in EXAMPLES]
    assert not (TWINS / "__init__.py").exists()


@pytest.mark.parametrize("name", ["01_bgv_basics", "02_ckks_basics"])
def test_twin_runs_on_cpu(name, capsys):
    load_twin(name).main(device="cpu")
    out = capsys.readouterr().out
    assert "product slots" in out or "max error of z^2" in out


def _value_lines(text: str) -> list:
    """The lines that carry values: every stdout line but warnings and
    lines with times."""
    return [ln for ln in text.splitlines()
            if ln.strip() and "WARNING" not in ln
            and not re.search(r"\b(ms|sec|seconds)\b", ln)]


def _same_line(got: str, want: str, ckks: bool) -> bool:
    if not ckks:
        return got == want
    if NUM.sub("#", got) != NUM.sub("#", want):
        return False
    for a, b in zip(NUM.findall(got), NUM.findall(want)):
        if a == b:
            continue
        x, y = float(a), float(b)
        mant = b.split("e")[0]
        if "e" in b and "." in mant:      # printed to fixed digits
            unit = 10.0 ** (int(b.split("e")[1]) - len(mant.split(".")[1]))
            ok = abs(x - y) <= unit * 1.0000001
        elif "." in b and len(b.split(".")[1]) <= 2:
            ok = abs(x - y) <= 10.0 ** -len(b.split(".")[1]) * 1.0000001
        else:
            ok = abs(x - y) <= 1e-2
        if not ok:
            return False
    return True


def _run(path: pathlib.Path, *args) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, str(path), *args], env=env,
                          capture_output=True, text=True, timeout=1500)


@pytest.mark.slow
@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_twin_prints_the_examples_values(path):
    twin = _run(TWINS / path.name, "--device", "cpu")
    assert twin.returncode == 0, twin.stderr[-2000:]
    ref = _run(path)
    if path.stem in REFERENCE_FAILS:
        assert ref.returncode != 0 and \
            REFERENCE_FAILS[path.stem] in ref.stderr, ref.stderr[-2000:]
    else:
        assert ref.returncode == 0, ref.stderr[-2000:]
    got, want = _value_lines(twin.stdout), _value_lines(ref.stdout)
    assert len(got) >= len(want) and want
    if ref.returncode == 0:
        assert len(got) == len(want)
    ckks = "ckks" in path.stem
    for g, w in zip(got, want):
        assert _same_line(g, w, ckks), (g, w)
