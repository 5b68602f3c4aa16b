"""The port's ``GroupNorm`` (``models/unet3d.py``) on a group of one value.

``F.group_norm`` refuses an input with one value a group ("Expected more
than 1 value per channel when training", in eval mode too); flax
normalises it to 0 and returns the offset. The port's ``GroupNorm``
calls the ATen op directly:

- UNet4d nf 2 / mf 8 at igres (4, 4, 4, 4), batch 1 (its bottleneck is
  1 x 1 x 1 x 1 with one channel a group) against flax, at
  ``test_torch_unet4d.py``'s tolerance (rtol 1e-4 / atol 1e-5);
- the tiny turb3d drive with ``--downsamp_xyz 2``, evaluated through
  ``--ckpt`` (batch 1 at that bottleneck): window 0 equals, bit for bit,
  the decode of models built at the eval grid from the run's state;
- on the repo's recipe shapes (the rb2d flagship's and the
  ``r5_turb3d_200x_big`` encoders at their training batches, the rb2d
  eval window) every GroupNorm's output is ``torch.equal`` to
  ``F.group_norm``'s.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from space_time_pde_torch.bridge import (
    flatten_tree, load_flax_params, seeded_flax_params)
from space_time_pde_torch.data.generator import beltrami_fields
from space_time_pde_torch.data import save_npz
from space_time_pde_torch.models import UNet3d as TUNet3d
from space_time_pde_torch.models import UNet4d as TUNet4d
from space_time_pde_torch.models.unet3d import GroupNorm
from space_time_pde_torch.train import trainer as ttrainer
from space_time_pde_torch.utils.checkpoint import latest_checkpoint
from space_time_pde_torch.utils.config import Config as TConfig
from space_time_pde_torch import inference as tinf
from space_time_pde_tpu.models import UNet4d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(family, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "experiments", family, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_group_of_one_value_matches_flax():
    case = dict(igres=(4, 4, 4, 4), nf=2, mf=8, out_features=4)
    model = UNet4d(in_features=4, **case)
    x = np.random.RandomState(0).randn(1, 4, 4, 4, 4, 4).astype(np.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = seeded_flax_params(
        {k: v.shape for k, v in flatten_tree(params).items()}, 5)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    tm = load_flax_params(TUNet4d(in_features=4, **case), params)
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, inp, out: seen.append(inp[0][0, 0].numel() *
                                        inp[0].shape[1] // m.num_groups))
        for m in tm.modules() if isinstance(m, GroupNorm)]
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    for h in hooks:
        h.remove()
    assert min(seen) == 1          # a group of one value was normalised
    with pytest.raises(ValueError, match="more than 1 value"):
        F.group_norm(torch.ones(1, 2, 1, 1, 1), 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_turb3d_drive_downsamp_2_evaluates_through_ckpt(tmp_path, capsys):
    for seed, nt in ((42, 10), (7, 10)):
        save_npz(str(tmp_path / f"beltrami_s{seed}.npz"),
                 beltrami_fields(seed, nt=nt, n=8))
    run = _cli("turb3d", "train_torch").main([
        "--device", "cpu", "--data_folder", str(tmp_path),
        "--train_data", "beltrami_s42.npz", "--eval_data", "beltrami_s7.npz",
        "--nt", "8", "--nz", "8", "--ny", "8", "--nx", "8",
        "--downsamp_t", "2", "--downsamp_xyz", "2", "--lat_dims", "4",
        "--unet_nf", "2", "--unet_mf", "8", "--imnet_nf", "2",
        "--n_samp_pts_per_crop", "16", "--batch_size_per_gpu", "2",
        "--pseudo_epoch_size", "4", "--inner_steps", "2", "--epochs", "1",
        "--alpha_pde", "0.1", "--log_dir", str(tmp_path / "log")])
    ckpt = str(tmp_path / "log" / "checkpoints")
    res = _cli("turb3d", "evaluation_torch").main([
        "--ckpt", ckpt, "--device", "cpu", "--eval_windows", "1",
        "--save_path", str(tmp_path / "pred.npz")])
    assert f"restored step 2 from ckpt={ckpt}" in capsys.readouterr().out
    state = run["state"]
    cfg = TConfig.from_dict(latest_checkpoint(ckpt)["extra"]["config"])
    lres0 = torch.as_tensor(res["lres0"])
    assert tuple(lres0.shape[:-1]) == (4, 4, 4, 4)
    unet, imnet = ttrainer.build_models(cfg, tuple(lres0.shape[:-1]), "cpu")
    unet.load_state_dict(state.unet.state_dict())
    imnet.load_state_dict(state.imnet.state_dict())
    want = tinf.make_dense_decoder(
        unet.eval(), imnet.eval(), tuple(res["window0"].shape[:-1]),
        chunk=res["provenance"]["chunk"])(lres0)
    assert torch.isfinite(res["window0"]).all()
    assert torch.equal(res["window0"], want)


RECIPES = [
    ("rb2d_train", TUNet3d, dict(igres=(4, 16, 16), nf=32, mf=512), 8),
    ("rb2d_eval", TUNet3d, dict(igres=(4, 16, 64), nf=32, mf=512), 1),
    ("turb3d_train", TUNet4d, dict(igres=(4, 8, 8, 8), nf=32, mf=256), 4),
]


@pytest.mark.parametrize("name,cls,kw,batch", RECIPES,
                         ids=[r[0] for r in RECIPES])
def test_group_norm_equals_torch_on_recipe_shapes(name, cls, kw, batch):
    torch.manual_seed(0)
    model = cls(in_features=4, out_features=64, **kw)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GroupNorm):
                m.weight.normal_(1.0, 0.1)
                m.bias.normal_(0.0, 0.1)
    checked = []

    def hook(m, inp, out):
        want = F.group_norm(inp[0], m.num_groups, m.weight, m.bias, m.eps)
        checked.append(torch.equal(out, want))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, GroupNorm)]
    x = torch.from_numpy(np.random.RandomState(1).randn(
        batch, *kw["igres"], 4).astype(np.float32))
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    assert len(checked) >= 9 and all(checked)
