"""The port's eval-data copies vs the JAX package's data modules.

``space_time_pde_torch.data`` carries its own copies (so the port never
imports the JAX package); they must give identical arrays.
"""

import numpy as np
import pytest

from space_time_pde_torch.data import RB2EvalData
from space_time_pde_torch.data import generator as tgen
from space_time_pde_torch.data import splits as tsplits
from space_time_pde_tpu.data import RB2DataLoader
from space_time_pde_tpu.data import generator as jgen
from space_time_pde_tpu.data import splits as jsplits


def test_taylor_green_matches_jax():
    got = tgen.taylor_green_fields(nt=5, nz=8, nx=12, viscosity=0.02)
    want = jgen.taylor_green_fields(nt=5, nz=8, nx=12, viscosity=0.02)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("lres_filter,lres_interp", [
    ("none", "linear"), ("none", "nearest"), ("gaussian", "linear"),
    ("median", "linear")])
def test_full_lres_sequence_matches_jax(tmp_path, lres_filter, lres_interp):
    rng = np.random.RandomState(0)
    fields = {c: rng.randn(20, 16, 24).astype(np.float32) for c in "pbuw"}
    np.savez(tmp_path / "a.npz", **fields)
    np.savez(tmp_path / "b.npz", **{c: v[:12] for c, v in fields.items()})
    kw = dict(data_folder=str(tmp_path), data_filename="a.npz,b.npz", nt=8,
              nz=16, nx=16, downsamp_t=2, downsamp_xz=4,
              lres_filter=lres_filter, lres_interp=lres_interp)
    got, want = RB2EvalData(**kw), RB2DataLoader(**kw)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.channel_mean, want.channel_mean)
    np.testing.assert_array_equal(got.channel_std, want.channel_std)
    for t0, nt in ((0, 8), (5, 12), (24, 8)):
        np.testing.assert_array_equal(got.full_lres_sequence(t0, nt),
                                      want.full_lres_sequence(t0, nt))


@pytest.mark.parametrize("n_frames,nt,n_windows", [
    (200, 16, 4), (32, 16, 3), (40, 16, 8)])
def test_splits_match_jax(n_frames, nt, n_windows):
    for parity in (0, 1):
        np.testing.assert_array_equal(
            tsplits.window_starts(n_frames, nt, n_windows, parity),
            jsplits.window_starts(n_frames, nt, n_windows, parity))
    np.testing.assert_array_equal(
        tsplits.test_windows(n_frames, nt, n_windows),
        jsplits.test_windows(n_frames, nt, n_windows))
    assert (vars(tsplits.SplitSpec.canonical())
            == vars(jsplits.SplitSpec.canonical()))


@pytest.mark.parametrize("train,leak", [
    ("rb2d_ra1e6_s42.npz,rb2d_ra1e6_s100.npz", False),
    ("rb2d_ra1e6_s42.npz,rb2d_ra1e6_s123.npz", True),
    ("rb2d_ra1e6_s7.npz", True)])
def test_check_train_files_matches_jax(train, leak):
    for pkg in (tsplits, jsplits):
        if leak:
            with pytest.raises(SystemExit, match="split protocol"):
                pkg.check_train_files(train, allow_leak=False)
            with pytest.warns(UserWarning):
                pkg.check_train_files(train, allow_leak=True)
        else:
            pkg.check_train_files(train, eval_data="rb2d_ra1e6_s7.npz",
                                  allow_leak=False)
