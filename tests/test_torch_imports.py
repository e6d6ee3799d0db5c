"""Import hygiene of the PyTorch port: helib_tpu_torch and the scripts in
tools/ import neither JAX nor anything of helib_tpu."""

import ast
import os
import pkgutil
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "helib_tpu_torch")


def _port_modules():
    import helib_tpu_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        helib_tpu_torch.__path__, "helib_tpu_torch."))


def _port_sources():
    tools = os.path.join(REPO, "tools")
    out = [os.path.join(tools, f) for f in os.listdir(tools)
           if f.endswith(".py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_importing_every_module_loads_no_jax():
    mods = _port_modules()
    assert {"helib_tpu_torch.ops.conv", "helib_tpu_torch.io",
            "helib_tpu_torch.ksstrategy", "helib_tpu_torch.dryrun",
            "helib_tpu_torch.ops.ntt2",
            "helib_tpu_torch.ops.probes", "helib_tpu_torch.ea",
            "helib_tpu_torch.encoded", "helib_tpu_torch.ptxt",
            "helib_tpu_torch.nt.polymod", "helib_tpu_torch.nt.slotalg",
            "helib_tpu_torch.nt.factoralign", "helib_tpu_torch.algos",
            "helib_tpu_torch.algos.sums",
            "helib_tpu_torch.algos.replicate",
            "helib_tpu_torch.powerful", "helib_tpu_torch.evalmap",
            "helib_tpu_torch.recryption", "helib_tpu_torch.algos.extract",
            "helib_tpu_torch.algos.hoisting", "helib_tpu_torch.algos.linpoly",
            "helib_tpu_torch.algos.matmul",
            "helib_tpu_torch.algos.polyeval", "helib_tpu_torch.utils",
            "helib_tpu_torch.algos.matching", "helib_tpu_torch.algos.benes",
            "helib_tpu_torch.algos.permutations",
            "helib_tpu_torch.algos.optimize_perms",
            "helib_tpu_torch.algos.binary",
            "helib_tpu_torch.algos.tablelookup",
            "helib_tpu_torch.algos.eqtesting", "helib_tpu_torch.algos.query",
            "helib_tpu_torch.algos.intraslot",
            "helib_tpu_torch.algos.random_matrices",
            "helib_tpu_torch.algos.matmul_ckks",
            "helib_tpu_torch.security", "helib_tpu_torch.argmap",
            "helib_tpu_torch.jitutil",
            "helib_tpu_torch.cli", "helib_tpu_torch.debugging",
            "helib_tpu_torch.io_helib", "helib_tpu_torch.io_helib_bin",
            "helib_tpu_torch.exceptions", "helib_tpu_torch.log",
            "helib_tpu_torch.timing", "helib_tpu_torch.norms",
            "helib_tpu_torch.parallel", "helib_tpu_torch.parallel.mesh",
            "helib_tpu_torch.parallel.sharded_ntt",
            "helib_tpu_torch.parallel.distributed",
            "helib_tpu_torch.entry"} <= set(mods)
    assert len(mods) >= 71
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'helib_tpu' or "
            "m.startswith('helib_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_sources_have_no_jax_or_reference_imports():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "helib_tpu"):
                    offenders.append(f"{os.path.relpath(path, REPO)}:"
                                     f"{node.lineno} {name}")
    # the example twins are scripts outside the package walk
    twins = [p for p in _port_sources()
             if os.path.dirname(p) == os.path.join(PKG, "examples")]
    assert len(twins) == 10
    assert len(_port_sources()) >= 77
    assert not offenders, offenders
