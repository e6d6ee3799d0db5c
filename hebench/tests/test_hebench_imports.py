"""What the benchmark's process and the reference load, by the top-level
name of every module, in fresh processes."""

import json
import subprocess
import sys

import _tiny

PROBE = ("import json, sys; sys.path.insert(0, {root!r}); {imports}; "
         "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))")


def loaded(imports: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=_tiny.ROOT,
                                            imports=imports)],
        capture_output=True, text=True, check=True, timeout=300,
        cwd=_tiny.ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    names = loaded("import glob, os; "
                   "import hebench.run, hebench.control, hebench.sweep; "
                   "from hebench import cells; "
                   "[cells._module(os.path.basename(os.path.dirname(f)), "
                   "os.path.basename(f)[:-3]) for f in "
                   "glob.glob('hebench/*/*.py') if not os.path.basename(f)"
                   ".startswith('_') and '/tests/' not in f]")
    assert "helib_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "helib_tpu"}


def test_reference_loads_nothing_of_either_package():
    names = loaded("import hebench.reference.ring, "
                   "hebench.reference.schemes, hebench.reference.numbth")
    assert not names & {"jax", "jaxlib", "flax", "helib_tpu",
                        "helib_tpu_torch"}
