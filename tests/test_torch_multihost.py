"""``parallel/dp.py::init_multihost`` with two processes joined through
the ``STPDE_*`` variables (as tests/test_multihost.py joins JAX's), and
the rb2d train CLI on 2 ranks against 1.

- Two processes, each its own rows of a linear least-squares batch: the
  all-reduced SGD step leaves both with the same weights, equal to the
  single-process step on the union of the rows.
- ``experiments/rb2d/train_torch.py`` at world 2 (tiny widths, one crop a
  rank) draws world 1's global batch from the seed and keeps its block:
  its first step's loss terms equal those of a world-1 run with two
  crops; the JAX drivers' refusals hold.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from space_time_pde_torch.data import save_npz, taylor_green_fields

from torch_ranks import ROOT, run_world


def test_two_process_dp_step(tmp_path):
    outs = run_world("multihost", 2, str(tmp_path))
    assert "multihost: process 0/2, backend gloo" in outs[0]["_log"]
    assert "multihost: process 1/2, backend gloo" in outs[1]["_log"]
    np.testing.assert_array_equal(outs[0]["w"], outs[1]["w"])
    xs, ys = [], []
    for pid in (0, 1):
        rng = np.random.RandomState(pid)
        xs.append(rng.randn(2, 3).astype(np.float32))
        ys.append(rng.randn(2, 1).astype(np.float32))
    x, y = np.concatenate(xs), np.concatenate(ys)
    w = np.zeros((3, 1))
    grad = 2 * x.T @ (x @ w - y) / len(x)
    np.testing.assert_allclose(outs[0]["w"], (w - 0.1 * grad).ravel(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(outs[0]["loss"]),
                               float(np.mean((x @ w - y) ** 2)), rtol=1e-5)


def _flags(folder, log, per_rank):
    return ["--device", "cpu", "--data_folder", folder,
            "--train_data", "tg.npz", "--eval_data", "tg.npz",
            "--nt", "8", "--nz", "32", "--nx", "32", "--downsamp_t", "2",
            "--downsamp_xz", "4", "--n_samp_pts_per_crop", "32",
            "--lat_dims", "4", "--unet_nf", "4", "--imnet_nf", "2",
            "--epochs", "1", "--pseudo_epoch_size", "2",
            "--batch_size_per_gpu", str(per_rank), "--alpha_pde", "0.05",
            "--rayleigh", "100", "--log_dir", log]


def _driver():
    from conftest import load_driver

    return load_driver("rb2d", "train_torch")


def test_train_cli_world2_first_step_equals_world1(tmp_path):
    folder = str(tmp_path)
    save_npz(os.path.join(folder, "tg.npz"),
             taylor_green_fields(nt=12, nz=32, nx=32))
    world1 = _driver().main(_flags(folder, str(tmp_path / "log1"), 2))
    cli = os.path.join(ROOT, "experiments", "rb2d", "train_torch.py")
    procs = []
    for pid in (0, 1):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   STPDE_COORDINATOR=f"file://{tmp_path}/store",
                   STPDE_NUM_PROCESSES="2", STPDE_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-u", cli]
            + _flags(folder, str(tmp_path / "log2"), 1),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, p in enumerate(procs):
        assert p.returncode == 0, f"rank {pid}:\n{outs[pid][-3000:]}"
    assert "world=2 (data 2 x space 1) backend=gloo" in outs[0]
    line = [ln for ln in outs[0].splitlines() if ln.startswith("epoch 0:")]
    assert line and not any(ln.startswith("epoch 0:")
                            for ln in outs[1].splitlines())
    e = world1["epochs"][0]
    want = (f"epoch 0: loss={e['loss']:.5f} reg={e['reg_loss']:.5f} "
            f"pde={e['pde_loss']:.5f}")
    assert line[0].startswith(want), (line[0], want)
    # Rank 0 alone wrote the checkpoint.
    assert os.listdir(tmp_path / "log2" / "checkpoints") == ["ckpt_1.pt"]


@pytest.mark.parametrize("extra,match", [
    (["--sharded_encoder"], "requires --space_devices"),
    (["--space_devices", "2"], "must divide device count 1"),
    (["--multihost", "--space_devices", "2"], "data axis only"),
])
def test_train_cli_parallel_refusals(tmp_path, extra, match):
    with pytest.raises(SystemExit, match=match):
        _driver().main(_flags(str(tmp_path), str(tmp_path / "log"), 2)
                       + extra)
