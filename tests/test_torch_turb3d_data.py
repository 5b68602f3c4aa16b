"""The port's turb3d data CLI (``experiments/turb3d/generate_data_torch.py``)
against the JAX package's (``experiments/turb3d/generate_data.py``).

``--device cpu`` runs the port's numpy copy of the closed form: the same
arrays bit for bit and the same file bytes as the JAX CLI, and seed 7 at
the default flags hashes to its line of ``data/SHA256SUMS.beltrami``. The
card path's arithmetic (torch in float64, cast once to float32) runs here
on the CPU: every field within 2^-22 of its max |value| from the numpy
copy, the rule the card is held to (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase T).
"""

import hashlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from space_time_pde_torch.data import generator as tgen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--nt", "4", "--nz", "8", "--ny", "8", "--nx", "8"]


def _cli(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "experiments", "turb3d", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("choice", [["--seed", "7"], []],
                         ids=["seed7", "abc_default"])
def test_cpu_cli_writes_the_jax_cli_file(tmp_path, monkeypatch, capsys,
                                         choice):
    port, jax_cli = _cli("generate_data_torch"), _cli("generate_data")
    port_out, jax_out = tmp_path / "port.npz", tmp_path / "jax.npz"
    port.main(SMALL + choice + ["--device", "cpu", "--out", str(port_out)])
    port_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["generate_data.py", *SMALL, *choice,
                                      "--out", str(jax_out)])
    jax_cli.main()
    jax_lines = capsys.readouterr().out.splitlines()
    assert port_out.read_bytes() == jax_out.read_bytes()
    with np.load(port_out) as a, np.load(jax_out) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    # The same lines, then where the port ran.
    assert port_lines[:-1] == [l.replace(str(jax_out), str(port_out))
                               for l in jax_lines]
    assert port_lines[-1].endswith("on cpu (numpy)")


def test_seed7_matches_the_pinned_checksum(tmp_path):
    out = tmp_path / "beltrami_s7.npz"
    _cli("generate_data_torch").main(["--seed", "7", "--device", "cpu",
                                      "--out", str(out)])
    with open(os.path.join(ROOT, "data", "SHA256SUMS.beltrami")) as f:
        pinned = dict(reversed(line.split()) for line in f if line.strip())
    assert hashlib.sha256(out.read_bytes()).hexdigest() == \
        pinned["data/beltrami_s7.npz"]


def test_torch_closed_form_within_the_card_rule():
    port = _cli("generate_data_torch")
    a, b, c, phases = tgen.beltrami_realization_params(123)
    kw = dict(nt=24, nz=32, ny=32, nx=32, viscosity=1e-2, dt=0.1, A=a, B=b,
              C=c, phases=phases)
    got = port.abc_flow_fields_torch(device=torch.device("cpu"), **kw)
    want = tgen.abc_flow_fields(**kw)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if np.ndim(v):
            assert np.abs(got[k] - v).max() <= 2.0 ** -22 * np.abs(v).max()
        else:
            assert got[k] == v


def test_cuda_without_a_card_exits(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is here: the CUDA path runs")
    with pytest.raises(SystemExit, match="no CUDA device"):
        _cli("generate_data_torch").main(SMALL + ["--seed", "7", "--out",
                                                  str(tmp_path / "x.npz")])
    assert not (tmp_path / "x.npz").exists()
