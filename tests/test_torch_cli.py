"""The port's command-line utilities: create-context / key-gen / encrypt /
decrypt in-process on device=cpu (the decrypted file equals the input mod
p^r), the context file byte-identical to helib_tpu.cli's, and no run on
the host CPU unless device=cpu is asked for."""

import numpy as np
import pytest
import torch

from helib_tpu import cli as jcli

from helib_tpu_torch import cli

torch.set_num_threads(1)

# the verify skill's parameters: m=45 has 2 slots (phi = 24, d = 12)
CTX_ARGS = ["m=45", "p=2", "r=1", "bits=240", "c=3"]


def test_cli_round_trip_on_cpu(tmp_path, capsys):
    d = tmp_path
    cli.main(["create-context", *CTX_ARGS, f"out={d / 'ctx.bin'}", "info",
              "device=cpu"])
    cli.main(["key-gen", f"ctx={d / 'ctx.bin'}", f"out={d / 'key'}",
              "seed=5", "device=cpu"])
    (d / "data.txt").write_text("1\n3\n")
    cli.main(["encrypt", f"ctx={d / 'ctx.bin'}", f"key={d / 'key.pk'}",
              f"in={d / 'data.txt'}", f"out={d / 'ct.bin'}", "device=cpu"])
    cli.main(["decrypt", f"ctx={d / 'ctx.bin'}", f"key={d / 'key.sk'}",
              f"in={d / 'ct.bin'}", f"out={d / 'out.txt'}", "device=cpu"])
    got = np.loadtxt(d / "out.txt", dtype=np.int64, ndmin=1)
    np.testing.assert_array_equal(got, [1, 1])          # mod p^r = 2
    out = capsys.readouterr().out
    assert "Context(scheme=bgv, m=45" in out
    assert "encrypted 2 values" in out and "decrypted ->" in out


def test_create_context_file_equals_helib_tpu(tmp_path):
    cli.main(["create-context", *CTX_ARGS, f"out={tmp_path / 'port.bin'}",
              "device=cpu"])
    jcli.main(["create-context", *CTX_ARGS, f"out={tmp_path / 'jax.bin'}"])
    port = (tmp_path / "port.bin").read_bytes()
    assert port == (tmp_path / "jax.bin").read_bytes()
    assert len(port) > 0


def test_cli_refuses_to_run_on_cpu_unasked(tmp_path, monkeypatch):
    """Without a GPU and without device=cpu every command fails before it
    writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["create-context", *CTX_ARGS,
                  f"out={tmp_path / 'ctx.bin'}"])
    assert not (tmp_path / "ctx.bin").exists()
    cli.main(["create-context", *CTX_ARGS, f"out={tmp_path / 'ctx.bin'}",
              "device=cpu"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["key-gen", f"ctx={tmp_path / 'ctx.bin'}",
                  f"out={tmp_path / 'key'}"])
    with pytest.raises(SystemExit):
        cli.main(["bogus"])
