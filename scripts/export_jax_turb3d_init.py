"""Export the state a JAX turb3d or rb2d run starts from, for the PyTorch
port.

Builds what ``experiments/turb3d/train.py`` (``--recipe turb3d``, the
default) or ``experiments/rb2d/train.py`` (``--recipe rb2d``) builds
before its first step at the flags of a ``command.sh`` (default the
``r5_turb3d_200x_big`` / ``r5_rb2d_4x_e900`` recipe's): its models
initialised by the driver's ``init_state4d`` / ``init_state`` at
``PRNGKey(--seed)``, Adam's moments zero, step 0. turb3d's initial state
is built in one jitted program, whose parameters are those of the
driver's op-by-op build bit for bit (``tests/test_torch_train_curve.py``
holds them). It writes them as ``scripts/export_torch_turb3d.py
--with_opt_state`` writes a checkpoint, so that the port's train CLI
with ``--resume <out>`` (or ``scripts/train_from_scratch.py --init
<out>``) starts from the JAX run's own initial parameters. Both drivers
of a family draw their batches from ``np.random.RandomState(seed)`` in
the same order, so on the same data the port then sees the JAX run's
batches too. The channel statistics in the file are placeholders (0 and
1): ``--resume`` reads none of them, the train CLI takes its own from
the data.

Runs on the CPU (JAX is forced there), a few seconds:
    python scripts/export_jax_turb3d_init.py --out /tmp/jax_turb3d_init.npz
    python scripts/export_jax_turb3d_init.py --recipe rb2d --out /tmp/i.npz
"""

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)

from export_torch_params import optimizer_state  # noqa: E402  (JAX on CPU)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from space_time_pde_tpu.train.trainer import make_optimizer  # noqa: E402
from space_time_pde_torch import bridge  # noqa: E402
from train_from_scratch import script_args  # noqa: E402

COMMANDS = {"turb3d": "log/r5_turb3d_200x_big/command.sh",
            "rb2d": "log/r5_rb2d_4x_e900/command.sh"}


def _turb3d(flags):
    """(cfg, seed, initial state, lres, the checkpoint's meta)."""
    spec = importlib.util.spec_from_file_location(
        "jax_turb3d_train", os.path.join(ROOT, "experiments", "turb3d",
                                         "train.py"))
    drv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drv)
    parser = argparse.ArgumentParser()
    drv.add_turb3d_args(parser)
    run = parser.parse_args(flags)
    # Field4DDataset's low-res lattice: max(2, crop // down-sampling).
    lres = tuple(max(2, c // d) for c, d in zip(
        (run.nt, run.nz, run.ny, run.nx),
        (run.downsamp_t,) + (run.downsamp_xyz,) * 3))
    unet, imnet = drv.build_turb3d_models(run, lres)
    cfg = drv.make_config(run)
    tx = make_optimizer(cfg, max(1, run.pseudo_epoch_size
                                 // run.batch_size_per_gpu))
    state = jax.jit(lambda key: drv.init_state4d(
        key, run, unet, imnet, tx, lres))(jax.random.PRNGKey(run.seed))
    targs = {k: getattr(run, k) for k in (
        "nt", "nz", "ny", "nx", "downsamp_t", "downsamp_xyz", "lat_dims",
        "unet_nf", "unet_mf", "imnet_nf", "viscosity")}
    return cfg, run.seed, state, lres, {"turb3d_args": targs, "epoch": -1}


def _rb2d(flags):
    """(cfg, seed, initial state, lres, the checkpoint's meta)."""
    from space_time_pde_tpu.train import build_models, init_state
    from space_time_pde_tpu.utils import add_args, config_from_args

    parser = argparse.ArgumentParser()
    add_args(parser)
    cfg = config_from_args(parser.parse_known_args(flags)[0])
    d = cfg.data
    # RB2DataLoader's low-res lattice: max(2, crop // down-sampling).
    lres = tuple(max(2, c // s) for c, s in zip(
        (d.nt, d.nz, d.nx), (d.downsamp_t, d.downsamp_xz, d.downsamp_xz)))
    unet, imnet = build_models(cfg, lres)
    tx = make_optimizer(cfg, max(1, cfg.train.pseudo_epoch_size
                                 // cfg.train.batch_size_per_gpu))
    state = init_state(jax.random.PRNGKey(cfg.train.seed), cfg, unet,
                       imnet, tx)
    return cfg, cfg.train.seed, state, lres, {"epoch": -1}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--recipe", choices=sorted(COMMANDS), default="turb3d")
    p.add_argument("--command", default="",
                   help="the JAX run's command.sh (repo-relative; default "
                        "the recipe's flagship run)")
    p.add_argument("--out", required=True, help="output .npz")
    args = p.parse_args(argv)
    command = args.command or COMMANDS[args.recipe]

    build = _turb3d if args.recipe == "turb3d" else _rb2d
    cfg, seed, state, lres, meta = build(script_args(command, "train.py"))
    params = jax.tree.map(np.asarray, state.params)
    opt, layout = optimizer_state(state.opt_state)
    bridge.save_exported(args.out, params, None, cfg.to_dict(),
                         np.zeros(4, np.float32), np.ones(4, np.float32),
                         int(state.step), opt_state=opt, meta=meta)
    n = sum(int(np.size(v)) for v in jax.tree.leaves(params))
    print(f"wrote {args.out}: the initial state of {command} (seed "
          f"{seed}, lres {lres}): step {int(state.step)}, {n} "
          f"parameters, optimizer state ({layout}, Adam count "
          f"{int(opt['count'])})")


if __name__ == "__main__":
    main()
