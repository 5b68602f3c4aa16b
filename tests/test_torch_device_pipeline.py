"""The port's training data path vs the JAX package's: the
``RB2DataLoader`` copy (host numpy, exact) and ``DeviceSampler`` (the
device-side batch assembly; f32 gathers and blends in another order,
rtol = atol = 1e-5), for the same ``RandomState``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from space_time_pde_torch.data import dataset as tdata
from space_time_pde_torch.data.device_pipeline import DeviceSampler
from space_time_pde_torch.data.prefetch import BatchPrefetcher
from space_time_pde_tpu.data import RB2DataLoader as JLoader
from space_time_pde_tpu.data.device_pipeline import \
    DeviceSampler as JSampler


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    fields = {c: rng.randn(14, 16, 24).astype(np.float32) for c in "pbuw"}
    np.savez(d / "a.npz", **fields, dt=0.1, dz=0.5, dx=0.25)
    np.savez(d / "b.npz", **{c: v[:10] for c, v in fields.items()})
    return str(d)


def _kw(folder, **over):
    kw = dict(data_folder=folder, data_filename="a.npz,b.npz", nt=8, nz=16,
              nx=16, n_samp_pts_per_crop=20, downsamp_t=2, downsamp_xz=4)
    kw.update(over)
    return kw


@pytest.mark.parametrize("over", [
    {}, {"lres_interp": "nearest"}, {"lres_filter": "gaussian"},
    {"velonly": True}, {"normalize_output": False}])
def test_loader_copy_matches_jax(folder, over):
    got, want = tdata.RB2DataLoader(**_kw(folder, **over)), \
        JLoader(**_kw(folder, **over))
    np.testing.assert_array_equal(got.valid_t0, want.valid_t0)
    np.testing.assert_array_equal(got.channel_std, want.channel_std)
    assert got.lres_shape == want.lres_shape
    assert got.coord_extents == want.coord_extents
    assert len(got) == len(want)
    a = got.sample_batch(np.random.RandomState(5), 3)
    b = want.sample_batch(np.random.RandomState(5), 3)
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_device_sampler_matches_jax(folder, interp):
    tds = tdata.RB2DataLoader(**_kw(folder, lres_interp=interp))
    jds = JLoader(**_kw(folder, lres_interp=interp))
    ts, js = DeviceSampler(tds, "cpu"), JSampler(jds)
    to, tp = ts.draw(np.random.RandomState(9), 4)
    jo, jp = js.draw(np.random.RandomState(9), 4)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tp, jp)
    got = ts.batch_fn(torch.from_numpy(to), torch.from_numpy(tp))
    want = js.batch_fn(jnp.asarray(jo), jnp.asarray(jp))
    for k in ("lres", "point_coord", "point_value"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    # And the host pipeline at the same origins and points.
    host = tds.batch_from_origins(to[:, 0], to[:, 1], to[:, 2], tp)
    for k in ("lres", "point_value"):
        np.testing.assert_allclose(got[k].numpy(), host[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_wrap_loss_refresh_and_filtered(folder):
    ds = tdata.RB2DataLoader(**_kw(folder))
    sampler = DeviceSampler(ds, "cpu")
    seen = {}
    loss = sampler.wrap_loss(lambda batch: seen.update(batch) or 0.0)
    o, p = sampler.draw(np.random.RandomState(1), 2)
    loss({"origins": torch.from_numpy(o), "point_coord": torch.from_numpy(p)})
    assert seen["lres"].shape == (2, *ds.lres_shape, 4)
    # refresh re-uploads the field into the same storage (a captured
    # step keeps reading it): a corrupted buffer is repaired in place.
    old, want = sampler.data, sampler.data.clone()
    old.fill_(float("nan"))
    assert sampler.refresh() is old and torch.equal(sampler.data, want)
    filtered = tdata.RB2DataLoader(**_kw(folder, lres_filter="median"))
    assert not DeviceSampler.supported(filtered)
    with pytest.raises(ValueError, match="lres_filter"):
        DeviceSampler(filtered, "cpu")


def test_prefetcher_keeps_order_and_surfaces_errors():
    counter = iter(range(100))
    with BatchPrefetcher(lambda: {"i": next(counter)}, depth=2) as pf:
        assert [pf.get()["i"] for _ in range(5)] == [0, 1, 2, 3, 4]

    def boom():
        raise RuntimeError("bad batch")

    with BatchPrefetcher(boom) as pf:
        with pytest.raises(RuntimeError, match="bad batch"):
            pf.get()
