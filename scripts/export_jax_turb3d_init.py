"""Export the state a JAX turb3d run starts from, for the PyTorch port.

Builds what ``experiments/turb3d/train.py`` builds before its first step
at the flags of a ``command.sh`` (default the ``r5_turb3d_200x_big``
recipe's): its ``UNet4d`` and ``ImNet`` initialised by ``init_state4d``
at ``PRNGKey(--seed)``, Adam's moments zero, step 0. It writes them as
``scripts/export_torch_turb3d.py --with_opt_state`` writes a checkpoint,
so that ``experiments/turb3d/train_torch.py --resume <out>`` (or
``scripts/train_from_scratch.py --init <out>``) starts from the JAX run's
own initial parameters. Both drivers draw their batches from
``np.random.RandomState(seed)`` in the same order, so on the same data
the port then sees the JAX run's batches too. The channel statistics in
the file are placeholders (0 and 1): ``--resume`` reads none of them,
the train CLI takes its own from the data.

Runs on the CPU (JAX is forced there), a few seconds:
    python scripts/export_jax_turb3d_init.py --out /tmp/jax_turb3d_init.npz
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--command", default="log/r5_turb3d_200x_big/command.sh",
                   help="the JAX run's command.sh (repo-relative)")
    p.add_argument("--out", required=True, help="output .npz")
    args = p.parse_args(argv)

    spec = importlib.util.spec_from_file_location(
        "jax_turb3d_train", os.path.join(ROOT, "experiments", "turb3d",
                                         "train.py"))
    drv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drv)
    parser = argparse.ArgumentParser()
    drv.add_turb3d_args(parser)
    run = parser.parse_args(script_args(args.command, "train.py"))
    # Field4DDataset's low-res lattice: max(2, crop // down-sampling).
    lres = tuple(max(2, c // d) for c, d in zip(
        (run.nt, run.nz, run.ny, run.nx),
        (run.downsamp_t,) + (run.downsamp_xyz,) * 3))
    unet, imnet = drv.build_turb3d_models(run, lres)
    cfg = drv.make_config(run)
    tx = make_optimizer(cfg, max(1, run.pseudo_epoch_size
                                 // run.batch_size_per_gpu))
    state = drv.init_state4d(jax.random.PRNGKey(run.seed), run, unet,
                             imnet, tx, lres)
    params = jax.tree.map(np.asarray, state.params)
    opt, layout = optimizer_state(state.opt_state)
    targs = {k: getattr(run, k) for k in (
        "nt", "nz", "ny", "nx", "downsamp_t", "downsamp_xyz", "lat_dims",
        "unet_nf", "unet_mf", "imnet_nf", "viscosity")}
    bridge.save_exported(args.out, params, None, cfg.to_dict(),
                         np.zeros(4, np.float32), np.ones(4, np.float32),
                         int(state.step), opt_state=opt,
                         meta={"turb3d_args": targs, "epoch": -1})
    n = sum(int(np.size(v)) for v in jax.tree.leaves(params))
    print(f"wrote {args.out}: the initial state of {args.command} (seed "
          f"{run.seed}, lres {lres}): step {int(state.step)}, {n} "
          f"parameters, optimizer state ({layout}, Adam count "
          f"{int(opt['count'])})")


if __name__ == "__main__":
    main()
