"""Train a tiny recipe with the JAX train CLI and with the port's, from
the same initial state on the same data, and print the two runs side by
side, epoch by epoch.

    python scripts/train_trajectory.py --recipe turb3d --work /tmp/traj
    python scripts/train_trajectory.py --recipe rb2d --work /tmp/traj \
        --port_threads 1,4
    python scripts/train_trajectory.py --recipe rb2d --work /tmp/traj \
        --per_step

Everything runs on the CPU. The recipes (``TRAJECTORY``) are the shape
of the flagships at a few channels: 8 steps an epoch, 4 epochs (the
whole cosine schedule), Huber PDE loss, seed 42. The data is the port's
numpy copy of the closed forms (Beltrami fields for turb3d, Taylor–Green
for rb2d). The JAX CLI (``experiments/{turb3d,rb2d}/train.py``) runs in a
fresh interpreter on one CPU device and one thread; the port's
(``train_torch.py --device cpu``) runs in this process from the JAX
run's own initial state (``export_jax_turb3d_init.py --recipe``, through
``--resume``), once for each torch thread count of ``--port_threads``
(default one thread: its sums then do not follow the machine's load;
each count splits them otherwise). Both draw their batches from
``np.random.RandomState(seed)`` in the same order, so they see the same
batches and step the same schedule. The table gives each epoch's
``train/loss``, ``eval/rel_l2`` and ``train/grad_norm`` of both runs with
their relative difference, and the skipped-update and recovery counts
each CLI printed. Last, the port's epoch eval (its CLI's eval batch,
drawn from ``RandomState(seed + 1)``, and eval function) on the
parameters of the JAX run's newest checkpoint, beside the
``eval/rel_l2`` that the JAX run logged at that step.

``--per_step`` trains the first epoch's batches one step an epoch (an
epoch's rows = the batch, ``--inner_steps 1``, ``STEPS_PER_EPOCH``
epochs, so a cosine schedule over those 8 steps): each step's metrics
logged, to find the step where the runs part.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)

# The in-process JAX (the initial state's export) compiles at the JAX
# CLI's optimisation level: the initial parameters differ between levels.
# JAX itself is imported where it is used, so the JAX CLIs start first.
_LEVEL = "--xla_backend_optimization_level=0"
if _LEVEL not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               + _LEVEL).strip()

STEPS_PER_EPOCH = 8
EPOCHS = 4
KEYS = ("train/loss", "eval/rel_l2", "train/grad_norm")

TRAJECTORY = {
    "turb3d": """python experiments/turb3d/train.py --data_folder data \\
  --train_data beltrami_s42.npz --eval_data beltrami_s7.npz \\
  --nt 8 --nz 8 --ny 8 --nx 8 --downsamp_t 2 --downsamp_xyz 4 \\
  --lat_dims 4 --unet_nf 2 --unet_mf 8 --imnet_nf 2 \\
  --n_samp_pts_per_crop 16 --batch_size_per_gpu 2 --inner_steps 2 \\
  --pseudo_epoch_size 16 --alpha_pde 0.1 --lr 5e-3 --lr_schedule cosine \\
  --pde_loss_type huber --epochs 4 --seed 42 --log_dir log/tiny
""",
    "rb2d": """python experiments/rb2d/train.py --data_folder data \\
  --train_data tg_s42.npz --val_data tg_s7.npz \\
  --nt 8 --nz 16 --nx 32 --downsamp_t 2 --downsamp_xz 4 \\
  --lat_dims 4 --unet_nf 4 --imnet_nf 4 --n_samp_pts_per_crop 32 \\
  --batch_size_per_gpu 2 --inner_steps 2 --pseudo_epoch_size 16 \\
  --alpha_pde 0.1 --lr 5e-3 --lr_schedule cosine --pde_loss_type huber \\
  --epochs 4 --seed 42 --log_dir log/tiny
""",
}


def _load(*parts):
    spec = importlib.util.spec_from_file_location(
        "_".join(parts)[:-3].replace("/", "_"), os.path.join(ROOT, *parts))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_data(recipe, folder):
    """The recipe's train and eval files in ``folder``."""
    from space_time_pde_torch.data import (beltrami_fields, save_npz,
                                           taylor_green_fields)
    if recipe == "turb3d":
        for seed in (42, 7):
            save_npz(os.path.join(folder, f"beltrami_s{seed}.npz"),
                     beltrami_fields(seed, nt=10, n=8))
    else:
        for seed, visc in ((42, 1e-2), (7, 2e-2)):
            save_npz(os.path.join(folder, f"tg_s{seed}.npz"),
                     taylor_green_fields(nt=12, nz=16, nx=32,
                                         viscosity=visc))


def recipe_flags(recipe, folder, per_step=False):
    """(the command.sh written to ``folder``, the train flags with
    ``--data_folder`` there and no ``--log_dir``)."""
    from train_from_scratch import flag, script_args, with_flag

    command = os.path.join(folder, "command.sh")
    with open(command, "w") as f:
        f.write(TRAJECTORY[recipe])
    flags = with_flag(script_args(command, "train.py"), "--data_folder",
                      folder)
    flags = flags[:flags.index("--log_dir")]
    if per_step:
        rows = flag(flags, "--batch_size_per_gpu")
        flags = with_flag(flags, "--pseudo_epoch_size", rows)
        flags = with_flag(flags, "--inner_steps", "1")
        flags = with_flag(flags, "--epochs", str(STEPS_PER_EPOCH))
    return command, flags


def start_jax(recipe, flags, log_dir):
    """The JAX train CLI in a fresh interpreter on one CPU device and one
    thread, at this process's XLA flags (the optimisation level that the
    test suite uses); its output goes to ``log_dir``'s ``stdout.txt``
    and ``stderr.txt``."""
    env = dict(os.environ, STPDE_PLATFORM="cpu", STPDE_CPU_DEVICES="1",
               XLA_FLAGS=os.environ["XLA_FLAGS"]
               + " --xla_cpu_multi_thread_eigen=false"
                 " intra_op_parallelism_threads=1")
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "stdout.txt"), "w") as out, \
            open(os.path.join(log_dir, "stderr.txt"), "w") as err:
        return subprocess.Popen(
            [sys.executable, "-u",
             os.path.join(ROOT, "experiments", recipe, "train.py")]
            + flags + ["--log_dir", log_dir], env=env, stdout=out,
            stderr=err)


def epochs_of(path):
    """[{key: value, "step": n}] a logged epoch, in order: the train and
    eval records of one step merged."""
    by_step = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            by_step.setdefault(rec["step"], {}).update(rec)
    return [by_step[s] for s in sorted(by_step)]


def counts(lines):
    """(skipped-update epochs, recoveries) as a train CLI printed them."""
    from train_from_scratch import RECOVERY_LINE, SKIP_LINE
    return (sum(1 for ln in lines if SKIP_LINE.match(ln)),
            sum(1 for ln in lines if RECOVERY_LINE.match(ln)))


def start(recipe, work, per_step=False):
    """Write the recipe's data and command.sh into ``work`` and start the
    JAX CLI there: a handle for :func:`finish` (or :func:`stop`)."""
    os.makedirs(work, exist_ok=True)
    write_data(recipe, work)
    command, flags = recipe_flags(recipe, work, per_step)
    return {"recipe": recipe, "work": work, "command": command,
            "flags": flags,
            "proc": start_jax(recipe, flags, os.path.join(work, "jax"))}


def stop(handle):
    """End the handle's JAX CLI if it still runs."""
    proc = handle["proc"]
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def finish(handle, threads=(1,)):
    """The port's runs beside the handle's JAX run: {"jax": [epochs],
    "jax_counts", "port": {thread count: [epochs]}, "port_counts":
    {count: counts}, "port_result": {count: the CLI's result},
    "eval_on_jax_params"}."""
    import torch

    recipe, work, flags = handle["recipe"], handle["work"], handle["flags"]
    own = torch.get_num_threads()
    runs = {"port": {}, "port_counts": {}, "port_result": {}}
    try:
        init = os.path.join(work, "init.npz")
        with contextlib.redirect_stdout(io.StringIO()):
            _load("scripts", "export_jax_turb3d_init.py").main(
                ["--recipe", recipe, "--command", handle["command"],
                 "--out", init])
        cli = _load("experiments", recipe, "train_torch.py")
        for n in threads:
            port_log = os.path.join(work, f"port_t{n}")
            buf = io.StringIO()
            torch.set_num_threads(n)
            with contextlib.redirect_stdout(buf):
                res = cli.main(flags + ["--device", "cpu", "--log_dir",
                                        port_log, "--resume", init])
            runs["port"][n] = epochs_of(os.path.join(port_log,
                                                     "metrics.jsonl"))
            runs["port_counts"][n] = counts(buf.getvalue().splitlines())
            runs["port_result"][n] = res
        handle["proc"].wait(timeout=600)
    finally:
        torch.set_num_threads(own)
        stop(handle)
    log = os.path.join(work, "jax")
    with open(os.path.join(log, "stdout.txt")) as f:
        out = f.read()
    if handle["proc"].returncode != 0:
        with open(os.path.join(log, "stderr.txt")) as f:
            err = f.read()
        raise RuntimeError(f"the JAX CLI exited {handle['proc'].returncode}"
                           ":\n" + out[-3000:] + err[-3000:])
    runs["jax"] = epochs_of(os.path.join(log, "metrics.jsonl"))
    runs["jax_counts"] = counts(out.splitlines())
    runs["eval_on_jax_params"] = eval_on_jax_params(recipe, work, flags)
    return runs


def run(recipe, work, per_step=False, threads=(1,)):
    """:func:`finish` of :func:`start`."""
    return finish(start(recipe, work, per_step), threads)


def departures(jax_epochs, port_epochs):
    """[{key: |port - JAX| / |JAX|}] an epoch, for each of ``KEYS``."""
    return [{k: abs(p[k] - j[k]) / abs(j[k]) for k in KEYS}
            for j, p in zip(jax_epochs, port_epochs)]


def eval_on_jax_params(recipe, work, flags):
    """(the step of the JAX run's newest checkpoint, the port's epoch eval
    on its parameters, the ``eval/rel_l2`` the JAX run logged there)."""
    import export_torch_params  # JAX forced to the CPU
    import jax
    import torch

    from space_time_pde_torch.bridge import load_flax_params
    from space_time_pde_torch.train import build_models, make_eval_fn

    ckpt = os.path.join(work, "jax", "checkpoints")
    step = max(int(d) for d in os.listdir(ckpt) if d.isdigit())
    state, _ = export_torch_params.restore(ckpt, step)
    params = jax.tree.map(np.asarray, state.params)
    cli = _load("experiments", recipe, "train_torch.py")
    p = argparse.ArgumentParser()
    if recipe == "turb3d":
        from space_time_pde_torch.data.dataset4d import Field4DDataset

        cli.add_turb3d_args(p)
        args = p.parse_args(flags)
        cfg = cli.make_config(args)
        kw = {k: getattr(args, k) for k in (
            "data_folder", "nt", "nz", "ny", "nx", "n_samp_pts_per_crop",
            "downsamp_t", "downsamp_xyz")}
        train, val = args.train_data, args.eval_data

        def load(name):
            return Field4DDataset(data_filename=name, **kw)
    else:
        from space_time_pde_torch.utils.config import (add_args,
                                                       config_from_args)

        add_args(p)
        args, _ = p.parse_known_args(flags)
        cfg = config_from_args(args)
        train = cfg.data.train_data
        val = flags[flags.index("--val_data") + 1]

        def load(name):
            return cli._loader(cfg, name)
    ds, eval_ds = load(train), load(val)
    eval_ds.channel_mean, eval_ds.channel_std = ds.channel_mean, \
        ds.channel_std
    unet, imnet = build_models(cfg, ds.lres_shape, "cpu")
    load_flax_params(unet, params["unet"])
    load_flax_params(imnet, params["imnet"])
    batch = eval_ds.sample_batch(np.random.RandomState(cfg.train.seed + 1),
                                 cfg.train.batch_size_per_gpu)
    got = make_eval_fn(cfg, unet, imnet)(
        {k: torch.as_tensor(v) for k, v in batch.items()})["rel_l2"]
    logged = next(e["eval/rel_l2"]
                  for e in epochs_of(os.path.join(work, "jax",
                                                  "metrics.jsonl"))
                  if e["step"] == step)
    return step, float(got), logged


def table(recipe, runs):
    """The runs side by side, one line an epoch, a block a thread count
    of the port."""
    lines = []
    for n, port in runs["port"].items():
        lines.append(f"{recipe}, the port at {n} torch thread(s): epoch "
                     "step " + " ".join(f"{k} (JAX, port, rel)"
                                        for k in KEYS))
        for i, (j, p, d) in enumerate(zip(runs["jax"], port,
                                          departures(runs["jax"], port))):
            lines.append(f"{i} {p['step']} " + " ".join(
                f"{j[k]:.9g} {p[k]:.9g} {d[k]:.2e}" for k in KEYS))
        lines.append(f"skipped-update epochs, recoveries: JAX "
                     f"{runs['jax_counts']}, port {runs['port_counts'][n]}")
    step, got, logged = runs["eval_on_jax_params"]
    lines.append(f"the port's epoch eval on the JAX run's step-{step} "
                 f"parameters: rel_l2 {got:.9g} (JAX logged {logged:.9g}, "
                 f"rel {abs(got - logged) / abs(logged):.2e})")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--recipe", choices=sorted(TRAJECTORY), default="turb3d")
    p.add_argument("--work", required=True,
                   help="a directory for the data and both runs")
    p.add_argument("--per_step", action="store_true",
                   help="one step an epoch over the same schedule")
    p.add_argument("--port_threads", default="1",
                   help="comma-separated torch thread counts: the port "
                        "runs once per count")
    args = p.parse_args(argv)
    runs = run(args.recipe, args.work, args.per_step,
               tuple(int(n) for n in args.port_threads.split(",")))
    print(table(args.recipe, runs))
    return runs


if __name__ == "__main__":
    main()
