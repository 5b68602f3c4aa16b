"""Export the turb3d checkpoint of the JAX package for the PyTorch port.

Restores ``<ckpt>/<step>`` (a ``experiments/turb3d/train.py``
checkpoint) from a temporary copy, as ``export_torch_params.py`` does,
and writes:

- ``<out>``: the exported ``.npz`` that the port reads with numpy alone
  (``space_time_pde_torch/bridge.py::load_exported``): params, channel
  stats, step, the config and, as ``meta``, the driver's
  ``turb3d_args`` (crop, down-sampling, widths, viscosity) and the
  epoch the run stopped at; with ``--with_opt_state`` also the
  optimizer state, so that ``experiments/turb3d/train_torch.py --resume
  <out>`` continues the run (as ``export_torch_params.py`` describes);
- ``<out>_ref.npz``: a JAX-CPU reference for the port's turb3d eval on
  the card. The val split's realization (``beltrami_s7``, made from the
  closed form as ``experiments/turb3d/generate_data.py --seed 7`` makes
  it) is cut to window 0 and encoded by the JAX ``UNet4d``; the JAX jnp
  query decodes ``--ref_points`` lattice points drawn with ``--seed``.
  The file keeps the flat lattice indices, the decoder outputs
  (normalised units) in float32 and, recomputed by the port's modules
  on the CPU in float64 (the JAX ``UNet4d`` casts its output to
  float32, so it cannot give one), in float64, the geometry, and a
  sha256 of the raw ``p, u, v, w`` arrays of the val and test
  realizations (the smoke run's data check where its zip bytes differ).

Runs on the CPU (JAX is forced there), about a minute. Usage:
    python scripts/export_torch_turb3d.py \
        --ckpt log/r5_turb3d_200x_big/checkpoints --step 76800 \
        --out space_time_pde_torch/assets/r5_turb3d_200x_big_76800.npz
"""

import argparse
import hashlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from export_torch_params import (  # noqa: E402  (forces JAX to CPU)
    optimizer_state, restore)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.interpolate import RegularGridInterpolator  # noqa: E402

from space_time_pde_tpu.data.generator import (  # noqa: E402
    abc_flow_fields, beltrami_realization_params)
from space_time_pde_tpu.models import (  # noqa: E402
    ImNet, UNet4d, query_local_implicit_grid)
from space_time_pde_torch import bridge  # noqa: E402
from space_time_pde_torch import models as tmodels  # noqa: E402

CHANNELS = ("p", "u", "v", "w")


def beltrami(seed: int):
    """The fields ``experiments/turb3d/generate_data.py --seed <seed>``
    writes (its default 24 x 32^3 grid)."""
    a, b, c, phases = beltrami_realization_params(seed)
    return abc_flow_fields(nt=24, nz=32, ny=32, nx=32, A=a, B=b, C=c,
                           phases=phases)


def array_digest(fields) -> str:
    """sha256 over the raw bytes of the p, u, v, w arrays, in order."""
    h = hashlib.sha256()
    for k in CHANNELS:
        h.update(np.ascontiguousarray(fields[k]).tobytes())
    return h.hexdigest()


def reference(params, targs, channel_mean, channel_std, n_points: int,
              seed: int):
    """JAX-CPU decoder outputs of val window 0 at seeded lattice points
    (see the module docstring)."""
    fields = beltrami(7)
    data = np.stack([fields[k] for k in CHANNELS], -1).astype(np.float32)
    nt = int(targs["nt"])
    hi_shape = data[:nt].shape[:4]
    lres_sizes = (max(2, nt // int(targs["downsamp_t"])),) + tuple(
        max(2, s // int(targs["downsamp_xyz"])) for s in hi_shape[1:])
    axes = [np.linspace(0, s - 1, n) for s, n in zip(hi_shape, lres_sizes)]
    lat_pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 4)
    interp = RegularGridInterpolator([np.arange(s) for s in hi_shape],
                                     data[:nt])
    lres = interp(lat_pts).reshape(*lres_sizes, -1).astype(np.float32)
    lres = (lres - channel_mean) / channel_std

    kw = dict(out_features=int(targs["lat_dims"]), nf=int(targs["unet_nf"]),
              mf=int(targs["unet_mf"]))
    unet = UNet4d(in_features=4, igres=lres_sizes, **kw)
    imnet = ImNet(dim=4, in_features=int(targs["lat_dims"]), out_features=4,
                  nf=int(targs["imnet_nf"]))
    latent = jax.jit(unet.apply)({"params": params["unet"]},
                                 jnp.asarray(lres)[None])
    idx = np.sort(np.random.RandomState(seed).choice(
        int(np.prod(hi_shape)), n_points, replace=False)).astype(np.int64)
    grid = [np.linspace(0, 1, n, dtype=np.float32) for n in hi_shape]
    pts = np.stack(np.meshgrid(*grid, indexing="ij"), -1).reshape(-1, 4)
    vals = query_local_implicit_grid(
        lambda v: imnet.apply({"params": params["imnet"]}, v),
        latent, jnp.asarray(pts[idx])[None])[0]

    # float64 on the port's modules (CPU).
    tunet = bridge.load_flax_params(
        tmodels.UNet4d(in_features=4, igres=lres_sizes, **kw),
        params["unet"]).double()
    timnet = bridge.load_flax_params(
        tmodels.ImNet(dim=4, in_features=int(targs["lat_dims"]),
                      out_features=4, nf=int(targs["imnet_nf"])),
        params["imnet"]).double()
    with torch.no_grad():
        lat64 = tunet(torch.from_numpy(lres).double()[None])
        vals64 = tmodels.query_local_implicit_grid(
            timnet, lat64, torch.from_numpy(pts[idx]).double()[None])[0]
    return {"index": idx, "values": np.asarray(vals, np.float32),
            "values_f64": vals64.numpy(), "out_shape": np.asarray(hi_shape),
            "t0": np.asarray(0), "seed": np.asarray(seed),
            "lres_shape": np.asarray(lres.shape),
            "eval_data": np.asarray("beltrami_s7.npz"),
            "digest_beltrami_s7": np.asarray(array_digest(fields)),
            "digest_beltrami_s123": np.asarray(array_digest(beltrami(123)))}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", required=True,
                        help="orbax checkpoint directory")
    parser.add_argument("--step", type=int, required=True)
    parser.add_argument("--out", required=True, help="output .npz")
    parser.add_argument("--ref_points", type=int, default=4096,
                        help="JAX reference points (0 = no reference)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--with_opt_state", action="store_true",
                        help="put the optimizer state into --out")
    args = parser.parse_args(argv)

    state, extra = restore(args.ckpt, args.step)
    params = jax.tree.map(np.asarray, state.params)
    targs = extra["turb3d_args"]
    mean = np.asarray(extra["channel_mean"], np.float32)
    std = np.asarray(extra["channel_std"], np.float32)
    opt = optimizer_state(state.opt_state)[0] if args.with_opt_state \
        else None
    bridge.save_exported(args.out, params, None, extra["config"], mean, std,
                         int(state.step), opt_state=opt,
                         meta={"turb3d_args": targs,
                               "epoch": int(extra.get("epoch", -1))})
    n = sum(int(np.size(v)) for v in jax.tree.leaves(params))
    print(f"wrote {args.out}: step {int(state.step)}, {n} parameters, "
          f"turb3d_args {targs}"
          + (", optimizer state" if opt is not None else ""))
    if not args.ref_points:
        return
    ref = reference(params, targs, mean, std, args.ref_points, args.seed)
    path = os.path.splitext(args.out)[0] + "_ref.npz"
    np.savez_compressed(path, **ref)
    r32, r64 = ref["values"].astype(np.float64), ref["values_f64"]
    print(f"wrote {path}: {args.ref_points} JAX-CPU reference points; max "
          f"|f32 - f64| {np.abs(r32 - r64).max():.3e}, max |ref| "
          f"{np.abs(r64).max():.4g}")


if __name__ == "__main__":
    main()
