"""The port's turb3d stack vs the JAX package, at small sizes.

- the Beltrami generator copies, array for array (exact);
- ``Field4DDataset`` (exact: the same numpy and scipy calls) and the
  4-D ``DeviceSampler`` (f32 gathers and blends in another order,
  rtol = atol = 1e-5), for the same ``RandomState``;
- the D = 4 jet's gradients (the plain twin through the autograd
  Function) vs the JAX jnp jet, at ``tests/test_fused_jet.py``'s
  tolerances (rtol 3e-4; atol 3e-3 latent grid, 5e-3 parameters);
- a turb3d loss (UNet4d, ImNet(dim=4), ns3d) and its gradients vs JAX
  ``make_loss_fn``, at ``tests/test_torch_trainer.py``'s tolerances;
- CPU drives of ``experiments/turb3d/{train,evaluation}_torch.py`` on a
  tiny model, and the committed turb3d export loading strictly.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from space_time_pde_torch import physics as tphys
from space_time_pde_torch import train as ttrain
from space_time_pde_torch.bridge import (
    flatten_tree, load_exported, load_flax_params, save_exported,
    seeded_flax_params, state_dict_from_flax)
from space_time_pde_torch.data import dataset4d as tdata4d
from space_time_pde_torch.data import generator as tgen
from space_time_pde_torch.data.device_pipeline import DeviceSampler
from space_time_pde_torch.models import ImNet as TImNet
from space_time_pde_torch.models import UNet4d as TUNet4d
from space_time_pde_torch.ops import fused_jet as tfj
from space_time_pde_torch.ops import fused_query as tfq
from space_time_pde_torch.utils.config import Config as TConfig
from space_time_pde_tpu.data import generator as jgen
from space_time_pde_tpu.data.dataset4d import Field4DDataset as JField4D
from space_time_pde_tpu.data.device_pipeline import \
    DeviceSampler as JSampler
from space_time_pde_tpu.models import ImNet, UNet4d
from space_time_pde_tpu.ops.jet import query_local_implicit_grid_jet
from space_time_pde_tpu.physics.systems import get_ns3d_pde_layer
from space_time_pde_tpu.train import make_loss_fn as jloss
from space_time_pde_tpu.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "space_time_pde_torch", "assets",
                     "r5_turb3d_200x_big_76800.npz")


def _driver(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "experiments", "turb3d", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [7, 42, 123])
def test_generator_copies_match_jax(seed):
    a, b, c, phases = jgen.beltrami_realization_params(seed)
    assert tgen.beltrami_realization_params(seed) == (a, b, c, phases)
    want = jgen.abc_flow_fields(nt=24, nz=32, ny=32, nx=32, A=a, B=b, C=c,
                                phases=phases)
    got = tgen.beltrami_fields(seed)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    small = dict(nt=3, nz=4, ny=5, nx=6, viscosity=0.1, dt=0.2)
    for k, v in jgen.abc_flow_fields(**small).items():
        np.testing.assert_array_equal(tgen.abc_flow_fields(**small)[k], v)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("beltrami")
    for seed, nt in ((42, 12), (100, 10)):
        tgen.save_npz(str(d / f"beltrami_s{seed}.npz"),
                      tgen.beltrami_fields(seed, nt=nt, n=12))
    return str(d)


def _kw(folder, **over):
    kw = dict(data_folder=folder,
              data_filename="beltrami_s42.npz,beltrami_s100.npz", nt=8,
              nz=8, ny=12, nx=8, n_samp_pts_per_crop=20, downsamp_t=2,
              downsamp_xyz=4)
    kw.update(over)
    return kw


@pytest.mark.parametrize("over", [{}, {"normalize_output": False},
                                  {"return_hres": True}])
def test_field4d_dataset_copy_matches_jax(folder, over):
    got, want = tdata4d.Field4DDataset(**_kw(folder, **over)), \
        JField4D(**_kw(folder, **over))
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
    for k, v in want[17].items():
        np.testing.assert_array_equal(got[17][k], v, err_msg=k)


def test_device_sampler_4d_matches_jax(folder):
    tds, jds = tdata4d.Field4DDataset(**_kw(folder)), JField4D(**_kw(folder))
    ts, js = DeviceSampler(tds, "cpu"), JSampler(jds)
    assert ts.crop_sizes == (8, 8, 12, 8) and ts.lres_sizes == (4, 2, 3, 2)
    to, tp = ts.draw(np.random.RandomState(9), 4)
    jo, jp = js.draw(np.random.RandomState(9), 4)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tp, jp)
    got = ts.batch_fn(torch.from_numpy(to), torch.from_numpy(tp))
    want = js.batch_fn(jnp.asarray(jo), jnp.asarray(jp))
    for k in ("lres", "point_coord", "point_value"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_jet_d4_gradients_match_jax():
    """d loss / d params and d loss / d latent for a loss mixing value,
    Jacobian and Hessian, at D = 4: the port's autograd Function (the
    plain twin on the CPU) vs autograd through the JAX jnp jet."""
    model = ImNet(dim=4, in_features=4, out_features=2, nf=2)
    params = model.init(jax.random.PRNGKey(4), jnp.zeros((1, 8)))["params"]
    tm = load_flax_params(TImNet(4, 4, 2, 2), params)
    rng = np.random.RandomState(5)
    latent = rng.randn(1, 3, 3, 4, 4, 4).astype(np.float32)
    pts = rng.rand(1, 12, 4).astype(np.float32)
    pts[0, :3] = [[0, 0, 0, 0], [1, 1, 1, 1], [0.5, 1.1, -0.1, 0.999]]
    cot = [rng.randn(1, 12, 2, *([4] * i)).astype(np.float32)
           for i in range(3)]

    def jl(p, lat):
        outs = query_local_implicit_grid_jet(
            lambda v: model.apply({"params": p}, v), lat, jnp.asarray(pts))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot))

    gp, gl = jax.jit(jax.grad(jl, argnums=(0, 1)))(params,
                                                   jnp.asarray(latent))
    lat_t = torch.from_numpy(latent).requires_grad_(True)
    tfj.reset_launches()
    outs = tfj.fused_query_jet(tm, lat_t, torch.from_numpy(pts))
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cot)).backward()
    assert tfj.LAUNCHES == {"jet_fwd": 0, "jet_bwd": 0,
                            "jet_fwd_bf16": 0, "jet_bwd_bf16": 0}
    np.testing.assert_allclose(lat_t.grad.numpy(), np.asarray(gl), rtol=3e-4,
                               atol=3e-3)
    want = state_dict_from_flax(tm, jax.tree.map(np.asarray, gp))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=3e-4, atol=5e-3, err_msg=name)


IGRES4 = (2, 4, 4, 4)


def _cfg4(derivs="jet"):
    cfg = Config()
    cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 6, 4, 2
    cfg.model.unet_mf = 8
    cfg.train.alpha_pde, cfg.train.pde_loss_type = 0.1, "huber"
    cfg.train.pde_derivs = derivs
    cfg.physics.pde_system, cfg.physics.viscosity = "ns3d", 1e-2
    return cfg


@pytest.mark.parametrize("derivs", ["jet", "jet_jnp"])
def test_turb3d_loss_and_grads_match_jax(derivs):
    cfg = _cfg4(derivs)
    rng = np.random.RandomState(1)
    mean, std = rng.randn(4), 0.5 + rng.rand(4)
    m = cfg.model
    unet = UNet4d(in_features=4, out_features=m.lat_dims, igres=IGRES4,
                  nf=m.unet_nf, mf=m.unet_mf)
    imnet = ImNet(dim=4, in_features=m.lat_dims, out_features=4,
                  nf=m.imnet_nf)
    params = {"unet": unet.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, *IGRES4, 4)))["params"],
              "imnet": imnet.init(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 10)))["params"]}
    batch = {"lres": rng.randn(2, *IGRES4, 4).astype(np.float32),
             "point_coord": rng.rand(2, 16, 4).astype(np.float32),
             "point_value": rng.randn(2, 16, 4).astype(np.float32)}
    kw = dict(mean=mean, std=std, t_crop=0.7, z_crop=2.0, y_crop=2.5,
              x_crop=3.0, viscosity=cfg.physics.viscosity)
    (want, wm), grads = jax.value_and_grad(
        jloss(cfg, unet, imnet, get_ns3d_pde_layer(**kw)),
        has_aux=True)(params, {k: jnp.asarray(v) for k, v in batch.items()})

    tcfg = TConfig.from_dict(cfg.to_dict())
    tunet, timnet = ttrain.build_models(tcfg, IGRES4, "cpu")
    assert isinstance(tunet, TUNet4d) and timnet.dim == 4
    load_flax_params(tunet, params["unet"])
    load_flax_params(timnet, params["imnet"])
    loss_fn = ttrain.make_loss_fn(tcfg, tunet, timnet,
                                  tphys.get_pde_layer("ns3d", **kw))
    got, gm = loss_fn({k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    for k in ("reg_loss", "pde_loss", "pde/continuity", "pde/momentum_x",
              "pde/momentum_y", "pde/momentum_z"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-4,
                                   err_msg=k)
    g_np = jax.tree.map(np.asarray, grads)
    top = max(float(np.abs(g).max()) for g in jax.tree.leaves(g_np))
    for name, module in (("unet", tunet), ("imnet", timnet)):
        want_g = state_dict_from_flax(module, g_np[name])
        for k, p in module.named_parameters():
            w = want_g[k].numpy()
            np.testing.assert_allclose(
                p.grad.numpy(), w, rtol=3e-4,
                atol=3e-4 * float(np.abs(w).max()) + 1e-6 * top,
                err_msg=f"{name}.{k}")


def _train_flags(folder, log_dir, *extra):
    return ["--device", "cpu", "--data_folder", folder,
            "--train_data", "beltrami_s42.npz,beltrami_s100.npz",
            "--eval_data", "beltrami_s42.npz", "--nt", "8", "--nz", "8",
            "--ny", "8", "--nx", "8", "--downsamp_t", "2",
            "--downsamp_xyz", "4", "--lat_dims", "4", "--unet_nf", "2",
            "--unet_mf", "4", "--imnet_nf", "2",
            "--n_samp_pts_per_crop", "16", "--batch_size_per_gpu", "2",
            "--pseudo_epoch_size", "4", "--inner_steps", "2",
            "--alpha_pde", "0.1", "--lr", "5e-3", "--lr_schedule", "cosine",
            "--pde_loss_type", "huber", "--log_dir", log_dir, *extra]


def test_train_cli_then_resume(folder, tmp_path, capsys):
    train_torch = _driver("train_torch")
    log = str(tmp_path / "log")
    tfj.reset_launches()
    tfq.reset_launches()
    first = train_torch.main(_train_flags(folder, log, "--epochs", "2"))
    out = capsys.readouterr().out
    assert "train provenance: device=cpu" in out and "tf32_matmul=False" \
        in out and "jet_fwd_plain" in out
    assert "epoch 1: loss=" in out
    assert [e["epoch"] for e in first["epochs"]] == [0, 1]
    assert first["step"] == 4            # 2 epochs x 2 steps
    assert all(np.isfinite(e["loss"]) and np.isfinite(e["eval/rel_l2"])
               for e in first["epochs"])
    assert sorted(os.listdir(os.path.join(log, "checkpoints"))) == \
        ["ckpt_2.pt", "ckpt_4.pt"]
    resumed = train_torch.main(_train_flags(
        folder, log, "--epochs", "3", "--resume",
        os.path.join(log, "checkpoints")))
    out = capsys.readouterr().out
    assert "resumed from step 4 (epoch 2)" in out
    assert resumed["start_epoch"] == 2 and resumed["step"] == 6
    assert [e["epoch"] for e in resumed["epochs"]] == [2]
    assert tfj.LAUNCHES == {"jet_fwd": 0, "jet_bwd": 0,
                            "jet_fwd_bf16": 0, "jet_bwd_bf16": 0}
    assert tfq.LAUNCHES == {"decode_blend_gather": 0, "decode_blend": 0,
                           "decode_blend_gather_bf16": 0,
                           "decode_blend_bf16": 0}


def test_train_cli_refusals(folder, tmp_path):
    train_torch = _driver("train_torch")
    log = str(tmp_path / "log")
    # The JAX driver's refusals: a space size that does not divide the
    # world (one rank here), the sharded encoder without space ranks.
    with pytest.raises(SystemExit, match="must divide device count 1"):
        train_torch.main(_train_flags(folder, log, "--space_devices", "2"))
    with pytest.raises(SystemExit, match="requires --space_devices"):
        train_torch.main(_train_flags(folder, log, "--sharded_encoder"))
    # --use_bf16 trains (tests/test_torch_bf16.py), with --pde_bf16 on the
    # bf16 jets (tests/test_torch_bf16_jet.py): neither is refused.
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            train_torch.main(_train_flags(folder, log)[2:])


def _tiny_export(path):
    """An exported .npz of seeded tiny weights with turb3d metadata: a
    (8, 12, 12, 12) crop, the whole 12^3 domain, down-sampled to igres
    (2, 4, 4, 4)."""
    targs = dict(nt=8, nz=12, ny=12, nx=12, downsamp_t=4, downsamp_xyz=3,
                 lat_dims=4, unet_nf=2, unet_mf=4, imnet_nf=2,
                 viscosity=1e-2)
    igres = (2, 4, 4, 4)
    unet = UNet4d(in_features=4, out_features=4, igres=igres, nf=2, mf=4)
    imnet = ImNet(dim=4, in_features=4, out_features=4, nf=2)
    shapes = {f"unet/{k}": v.shape for k, v in flatten_tree(unet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *igres, 4)))["params"]).items()}
    shapes.update({f"imnet/{k}": v.shape for k, v in flatten_tree(imnet.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8)))["params"]).items()})
    cfg = Config()
    cfg.data.eval_data = "beltrami_s42.npz"
    save_exported(path, seeded_flax_params(shapes, 0), None, cfg.to_dict(),
                  np.zeros(4, np.float32), np.ones(4, np.float32), 11,
                  meta={"turb3d_args": targs})


def test_eval_cli_prints_rel_l2(folder, tmp_path, capsys):
    params = str(tmp_path / "w.npz")
    _tiny_export(params)
    evaluation_torch = _driver("evaluation_torch")
    res = evaluation_torch.main([
        "--params", params, "--device", "cpu", "--data_folder", folder,
        "--eval_windows", "3", "--query_chunk", "1000",
        "--save_path", str(tmp_path / "pred.npz")])
    out = capsys.readouterr().out
    assert "restored step 11" in out and "cudnn=True" in out
    assert res["t0s"] == [0, 2, 4]
    assert out.count(": rel_l2 = ") == 3 and "per-channel (p,u,v,w)" in out
    assert len(res["rel_l2"]) == 3 and np.isfinite(res["rel_l2"]).all()
    assert tuple(res["window0"].shape) == (8, 12, 12, 12, 4)
    with np.load(tmp_path / "pred.npz") as z:
        assert z["u"].shape == (8, 12, 12, 12)
    assert tfq.LAUNCHES["decode_blend_gather"] == 0
    # The whole 12-frame sequence from overlapping windows.
    res = evaluation_torch.main([
        "--params", params, "--device", "cpu", "--data_folder", folder,
        "--full_sequence", "--save_path", str(tmp_path / "seq.npz")])
    out = capsys.readouterr().out
    assert "stitched 2 windows (stride 4) over 12 frames" in out
    assert "full-sequence rel_l2 = " in out


def test_exported_turb3d_asset_loads_strictly():
    exported = load_exported(ASSET)
    targs = exported["meta"]["turb3d_args"]
    assert exported["step"] == 76800
    assert (targs["nt"], targs["nz"], targs["ny"], targs["nx"]) == \
        (8, 32, 32, 32)
    unet = TUNet4d(in_features=4, out_features=targs["lat_dims"],
                   igres=(4, 8, 8, 8), nf=targs["unet_nf"],
                   mf=targs["unet_mf"])
    imnet = TImNet(4, targs["lat_dims"], 4, targs["imnet_nf"])
    load_flax_params(unet, exported["params"]["unet"])
    load_flax_params(imnet, exported["params"]["imnet"])
    n = sum(p.numel() for m in (unet, imnet) for p in m.parameters())
    assert n == sum(v.size for v in
                    flatten_tree(exported["params"]).values())


def _conv1d_forward(self, x):
    """``Conv4d.forward`` with the temporal factor as ``F.conv1d`` (space
    folded into its batch, as the flax model and the JAX reference do it)
    in place of the port's one matrix product."""
    import torch.nn.functional as F

    b, c, t = x.shape[:3]
    h = self._conv_space(x.transpose(1, 2).reshape(b * t, c, *x.shape[3:]))
    f, z2, y2, x2 = h.shape[1:]
    h = h.reshape(b, t, f, z2, y2, x2).permute(0, 3, 4, 5, 2, 1)
    total = max((-(-t // self.stride) - 1) * self.stride + self.kt - t, 0)
    h = F.pad(h.reshape(-1, f, t), (total // 2, total - total // 2))
    h = F.conv1d(h, self.temporal.weight, self.temporal.bias,
                 stride=self.stride)
    return h.reshape(b, z2, y2, x2, f, -1).permute(0, 4, 5, 1, 2, 3)


def test_temporal_product_gradients_as_close_as_conv1d():
    """The turb3d step of ``test_turb3d_loss_and_grads_match_jax`` with
    UNet4d's temporal conv as the port's one matrix product and as a
    cuDNN-free ``F.conv1d``, each in f32 against the product in float64
    (the two agree to 1e-10 there): per leaf, the atol at rtol 1e-4 (a
    fraction of the leaf's max |g|; of the model's largest where the
    leaf is ~0) at which it meets float64. With the encoder on float64's
    LeakyReLU branches in both, the product's worst leaf stays within 2x
    the Conv1d's and its mean within 1.5x: its summation order is not
    what moved the card's turb3d step 2.5x (ROADMAP queue 3 item 3)."""
    import contextlib
    from unittest import mock

    import torch.nn.functional as F

    from space_time_pde_torch.models import Conv4d as TConv4d

    cfg = _cfg4("jet")
    rng = np.random.RandomState(1)
    mean, std = rng.randn(4), 0.5 + rng.rand(4)
    m = cfg.model
    params = {
        "unet": UNet4d(in_features=4, out_features=m.lat_dims, igres=IGRES4,
                       nf=m.unet_nf, mf=m.unet_mf).init(
            jax.random.PRNGKey(0), jnp.zeros((1, *IGRES4, 4)))["params"],
        "imnet": ImNet(dim=4, in_features=m.lat_dims, out_features=4,
                       nf=m.imnet_nf).init(
            jax.random.PRNGKey(1), jnp.zeros((1, 10)))["params"]}
    batch = {"lres": rng.randn(2, *IGRES4, 4).astype(np.float32),
             "point_coord": rng.rand(2, 16, 4).astype(np.float32),
             "point_value": rng.randn(2, 16, 4).astype(np.float32)}
    kw = dict(mean=mean, std=std, t_crop=0.7, z_crop=2.0, y_crop=2.5,
              x_crop=3.0, viscosity=cfg.physics.viscosity)

    def step(dtype, conv1d):
        tcfg = TConfig.from_dict(cfg.to_dict())
        tcfg.train.pde_derivs = "jet_jnp" if dtype == torch.float64 else \
            "jet"
        tunet, timnet = ttrain.build_models(tcfg, IGRES4, "cpu")
        load_flax_params(tunet, params["unet"])
        load_flax_params(timnet, params["imnet"])
        tunet.to(dtype), timnet.to(dtype)
        pres = []
        for mod in tunet.modules():
            if callable(getattr(mod, "act", None)):
                mod.act = lambda x: (pres.append(x.detach() > 0),
                                     F.leaky_relu(x, 0.01))[1]
        with (mock.patch.object(TConv4d, "forward", _conv1d_forward)
              if conv1d else contextlib.nullcontext()):
            loss, _ = ttrain.make_loss_fn(
                tcfg, tunet, timnet, tphys.get_pde_layer("ns3d", **kw))(
                    {k: torch.from_numpy(v).to(dtype)
                     for k, v in batch.items()})
            loss.backward()
        return ({f"{n}.{k}": p.grad.double().numpy()
                 for n, mod in (("unet", tunet), ("imnet", timnet))
                 for k, p in mod.named_parameters()}, pres)

    g64, b64 = step(torch.float64, False)
    g64c, _ = step(torch.float64, True)
    top = max(float(np.abs(g).max()) for g in g64.values())
    assert max(float(np.abs(g64c[k] - g64[k]).max()) for k in g64) <= \
        1e-10 * top

    def needs(g):
        out = {}
        for k, r in g64.items():
            scale = float(np.abs(r).max())
            scale = scale if scale > 1e-5 * top else top
            out[k] = max(0.0, float(np.max(np.abs(g[k] - r)
                                           - 1e-4 * np.abs(r)))) / scale
        return out

    need = {}
    for label, conv1d in (("product", False), ("conv1d", True)):
        g, branches = step(torch.float32, conv1d)
        flips = sum(int((a != b).sum()) for a, b in zip(branches, b64))
        need[label] = needs(g)
        worst = max(need[label], key=need[label].get)
        print(f"turb3d step, temporal conv as {label}: {flips} encoder "
              f"branch flips vs float64; worst leaf needs atol "
              f"{need[label][worst]:.3e} x scale ({worst}), mean over the "
              f"{len(g)} leaves {np.mean(list(need[label].values())):.3e}")
        assert flips == 0, label
    worst = {k: max(v.values()) for k, v in need.items()}
    mean = {k: np.mean(list(v.values())) for k, v in need.items()}
    assert worst["product"] <= 2 * worst["conv1d"], worst
    assert mean["product"] <= 1.5 * mean["conv1d"], mean
