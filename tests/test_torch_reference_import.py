"""The port's reference-checkpoint import (``space_time_pde_torch/utils/
torch_import.py``) against the JAX package's (``space_time_pde_tpu/utils/
torch_import.py``).

- The independent oracle's ImNet (``tests/torch_oracle.py::TorchImNet``)
  through both imports: the flax ImNet and the port's ImNet give the
  same outputs on seeded points at ``test_parity_affordances.py``'s
  tolerance (rtol = atol = 1e-5), and the port's weights are the flax
  ones carried over by the bridge, bit for bit; the naming rules and
  error messages are the JAX module's.
- A synthetic ``name_map`` round trip for a small BatchNorm UNet3d: a
  reference-style ``state_dict`` (the port's tensors under other names,
  a transposed conv tagged ``!T``) through both imports; every tensor of
  the port's import equals JAX's ``unet3d_params_from_torch`` carried
  over by the bridge, bit for bit, and both models give the same
  eval-mode latents.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from space_time_pde_torch.bridge import state_dict_from_flax
from space_time_pde_torch.models import ImNet, UNet3d
from space_time_pde_torch.utils import torch_import as timp
from space_time_pde_tpu.models import ImNet as JImNet
from space_time_pde_tpu.models import UNet3d as JUNet3d
from space_time_pde_tpu.utils import torch_import as jimp
from torch_oracle import TorchImNet

IGRES = (4, 8, 8)


def _oracle(seed=0):
    torch.manual_seed(seed)
    return TorchImNet(dim=3, in_features=8, out_features=4, nf=2)


def test_imnet_import_matches_flax_and_oracle():
    tnet = _oracle()
    sd = tnet.state_dict()
    jparams = jimp.imnet_params_from_torch(sd)
    port = timp.load_reference_imnet(
        ImNet(dim=3, in_features=8, out_features=4, nf=2), sd)
    bridged = state_dict_from_flax(port, jparams)
    for k, v in port.state_dict().items():
        assert torch.equal(v, bridged[k]), k
    x = np.random.RandomState(0).randn(17, 11).astype(np.float32)
    want = np.asarray(JImNet(dim=3, in_features=8, out_features=4,
                             nf=2).apply({"params": jax.tree.map(
                                 jnp.asarray, jparams)}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        oracle = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


def test_imnet_layer_key_and_missing_layer_as_jax():
    sd = {k.replace("fcs.", "fc"): v for k, v in _oracle(1).state_dict()
          .items()}
    key = lambda i: f"fc{i}"
    got = timp.imnet_state_dict_from_torch(sd, key)
    want = jimp.imnet_params_from_torch(sd, key)
    for i in range(6):
        np.testing.assert_array_equal(got[f"fc{i}.weight"].numpy().T,
                                      want[f"fc{i}"]["kernel"])
        np.testing.assert_array_equal(got[f"fc{i}.bias"].numpy(),
                                      want[f"fc{i}"]["bias"])
    errors = []
    for imp in (timp.imnet_state_dict_from_torch,
                jimp.imnet_params_from_torch):
        with pytest.raises(KeyError) as e:
            imp(sd)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "adapt layer_key" in errors[0]


def test_unet3d_import_needs_a_name_map():
    for imp in (timp.unet3d_state_dict_from_torch,
                jimp.unet3d_params_from_torch):
        with pytest.raises(NotImplementedError, match="SURVEY.md §0"):
            imp({})


def _reference_unet3d(seed=0):
    """A seeded BatchNorm UNet3d and its tensors renamed as a reference
    checkpoint might hold them, with the name_map between them."""
    torch.manual_seed(seed)
    unet = UNet3d(in_features=4, out_features=8, igres=IGRES, nf=4,
                  norm="batch")
    with torch.no_grad():
        for name, t in unet.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand_like(t))
            elif t.is_floating_point():
                t.copy_(0.2 * torch.randn_like(t))
    ref, name_map = {}, {}
    for i, (path, mod) in enumerate(unet.named_modules()):
        if not isinstance(mod, (torch.nn.Conv3d, torch.nn.ConvTranspose3d,
                                torch.nn.BatchNorm3d)) and \
                type(mod).__name__ != "BatchNorm":
            continue
        prefix = f"encoder.{i}." + path.replace(".", "_")
        tag = "!T" if isinstance(mod, torch.nn.ConvTranspose3d) else ""
        name_map[path.replace(".", "/")] = prefix + tag
        for leaf, t in mod.state_dict().items():
            ref[f"{prefix}.{leaf}"] = t.clone()
    return unet, ref, name_map


def test_unet3d_name_map_round_trip_matches_jax():
    src, ref, name_map = _reference_unet3d()
    got = timp.unet3d_state_dict_from_torch(ref, name_map)
    params, stats = jimp.unet3d_params_from_torch(ref, name_map)
    port = UNet3d(in_features=4, out_features=8, igres=IGRES, nf=4,
                  norm="batch")
    timp.load_reference_unet3d(port, ref, name_map)
    bridged = state_dict_from_flax(port, params, stats)
    assert sorted(got) == sorted(src.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k
        assert torch.equal(v, bridged[k]), k
    x = np.random.RandomState(2).randn(2, *IGRES, 4).astype(np.float32)
    want = np.asarray(JUNet3d(in_features=4, out_features=8, igres=IGRES,
                              nf=4, norm="batch").apply(
        {"params": jax.tree.map(jnp.asarray, params),
         "batch_stats": jax.tree.map(jnp.asarray, stats)},
        jnp.asarray(x), train=False))
    port.eval()
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    del ref[next(k for k in ref if k.endswith("conv_in.weight"))]
    with pytest.raises(KeyError):
        timp.unet3d_state_dict_from_torch(ref, name_map)
