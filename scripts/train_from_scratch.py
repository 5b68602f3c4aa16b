"""Train a flagship recipe from scratch on the card, on data the card makes,
and hold its curve against the JAX runs' committed curves.

    python scripts/train_from_scratch.py --recipe rb2d --policy f32 \
        --run_epochs 60 --work /tmp/scratch_rb2d

One command a run, in four stages, each a CLI of the port called in this
process with the command line it prints (``--dry_run`` prints them and
runs nothing):

(a) data: the recipe's seeds through the twin data CLIs
    (``experiments/{rb2d,turb3d}/generate_data_torch.py``, on the card),
    with the flags of ``data/regen_rb2d.sh`` or ``data/regen_beltrami.sh``
    read from those scripts, into ``<work>/data``; a file that exists is
    skipped. The seeds are those of the JAX run's ``--train_data`` and
    its val file, and for rb2d the test seed of the dense eval;
(b) training: the port's train CLI with every flag of the JAX run's
    ``command.sh`` (``log/r5_rb2d_4x_e900/command.sh`` or
    ``log/r5_turb3d_200x_big/command.sh``), read from the file, with
    ``--data_folder`` and ``--log_dir`` moved under ``<work>``, plus
    ``--run_epochs N`` and the policy's flags: the same lr schedule, step
    for step, as the JAX run's first N epochs. It prints every skipped
    update and every cliff recovery with its epoch (the CLI's own lines),
    their counts, the s/step of each sitting's epochs after its first
    and whether the final parameters are finite;
(c) the curve: ``scripts/train_curve.py`` against the JAX runs' metrics
    (r4 and r5 for rb2d, r5 for turb3d). Under ``--policy f32`` its band
    is held (a window outside fails the command); under
    ``use_bf16_pde_bf16`` it is reported, as no JAX run of that policy is
    committed;
(d) the eval CLI's dense eval of the run's newest checkpoint on the val
    and test seeds, 4 windows each (``--split val|test --eval_windows
    4``, the protocol of ``log/r5_rb2d_4x_e900/eval_cpu.log`` and of
    ``space_time_pde_torch/assets/r5_turb3d_200x_big_76800_eval_cpu.log``).
    For turb3d each split's mean rel-L2 is held, once the run has
    reached the recipe's last epoch, within ``[CURVE_LOW, CURVE_HIGH]``
    x the JAX model's mean in that log (the curve's band applied to the
    final model); a shorter run's is reported beside the band.

``--seed N`` overrides the ``command.sh`` seed (the initialisation and
the batch draws) and names the run ``<recipe>_<policy>_s<N>``; without
it the run is the recipe's own seed. ``--continue_run`` continues the
run in its directory from its newest checkpoint for ``--run_epochs``
more epochs (the train CLI's ``--resume`` of its own checkpoints, which
draws the batches from the seed's start again), then holds the curve and
evaluates the whole run: a recipe longer than one sitting is trained in
several.

Where a held window falls outside the band, two options separate the
data from the training: ``--data_device cpu`` writes the data with the
port's numpy copies (the bytes the JAX runs trained and evaluated on)
instead of on the card, and ``--init FILE`` starts the run from an
exported state through the train CLI's ``--resume`` (for turb3d, the JAX
run's own initial parameters: ``scripts/export_jax_turb3d_init.py``).
Each names the run's directory (``<recipe>_<policy>[_cpu_data][_init]``).

``--smoke`` trains on the recipe's first train seed alone, as train and
val data (``--run_epochs`` defaults to 2 there), checks only that every
epoch logged every key the curve reads (``train_curve.py --keys_only``)
and runs no dense eval. The last line is one JSON object of the readings,
also written to ``<run dir>/summary.json``.
"""

import argparse
import contextlib
import importlib.util
import json
import math
import os
import re
import shlex
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RECIPES = {
    "rb2d": dict(
        command="log/r5_rb2d_4x_e900/command.sh",
        refs=("log/r4_rb2d_4x_e900/metrics.jsonl",
              "log/r5_rb2d_4x_e900/metrics.jsonl"),
        regen="data/regen_rb2d.sh",
        generate="experiments/rb2d/generate_data_torch.py",
        train="experiments/rb2d/train_torch.py",
        evaluate="experiments/rb2d/evaluation_torch.py",
        test_file="rb2d_ra1e6_s123.npz", final_eval=None),
    "turb3d": dict(
        command="log/r5_turb3d_200x_big/command.sh",
        refs=("log/r5_turb3d_200x_big/metrics.jsonl",),
        regen="data/regen_beltrami.sh",
        generate="experiments/turb3d/generate_data_torch.py",
        train="experiments/turb3d/train_torch.py",
        evaluate="experiments/turb3d/evaluation_torch.py",
        test_file="beltrami_s123.npz",
        final_eval="space_time_pde_torch/assets/"
                   "r5_turb3d_200x_big_76800_eval_cpu.log"),
}
POLICIES = {"f32": [],
            "use_bf16_pde_bf16": ["--use_bf16", "true", "--pde_bf16", "true"]}
CURVE = "scripts/train_curve.py"
SHELL_OPERATORS = ("||", "&&", "|", ";", ">", ">>", "2>", "&")


def script_args(path, script):
    """The arguments that the shell script ``path`` passes to ``script``
    (a path ending), its backslash continuations joined, up to the first
    shell operator."""
    with open(os.path.join(ROOT, path)) as f:
        text = f.read().replace("\\\n", " ")
    for line in text.splitlines():
        tokens = shlex.split(line, comments=True)
        for i, tok in enumerate(tokens):
            if tok.endswith(script):
                args = []
                for t in tokens[i + 1:]:
                    if t in SHELL_OPERATORS:
                        break
                    args.append(t)
                return args
    raise SystemExit(f"{path} does not run {script}")


def flag(args, name):
    return args[args.index(name) + 1]


def with_flag(args, name, value):
    """``args`` with ``name``'s value replaced (appended if absent)."""
    out = list(args)
    if name in out:
        out[out.index(name) + 1] = value
    else:
        out += [name, value]
    return out


def without_flags(args, names):
    out, skip = [], False
    for t in args:
        if skip:
            skip = False
        elif t in names:
            skip = True
        else:
            out.append(t)
    return out


def seed_of(name):
    m = re.search(r"_s(\d+)\.npz$", name)
    if not m:
        raise SystemExit(f"no seed in the file name {name!r}")
    return int(m.group(1))


def jax_final_means(path):
    """{split: mean rel-L2} of a committed JAX eval log (repo-relative):
    the ``rel_l2 = M (std ...)`` line after each ``split=S:`` line."""
    means, split = {}, None
    with open(os.path.join(ROOT, path)) as f:
        for line in f:
            m = re.match(r"split=(\w+): evaluating", line)
            if m:
                split = m.group(1)
            m = re.match(r"rel_l2 = ([0-9.]+) \(std", line)
            if m and split:
                means[split] = float(m.group(1))
    return means


def final_band(mean, ref, held):
    """The final model's mean rel-L2 on a split against the JAX model's
    ``ref``: inside ``[CURVE_LOW x ref, CURVE_HIGH x ref]``, the curve
    tool's band; ``held`` says whether it counts (a run that reached the
    recipe's last epoch)."""
    curve = _module(CURVE)
    lo, hi = curve.CURVE_LOW * ref, curve.CURVE_HIGH * ref
    return {"mean": mean, "jax_mean": ref, "band": [lo, hi],
            "inside": bool(lo <= mean <= hi), "held": held}


def plan(args):
    """The stages' command lines: {"data": [(path, argv)], "train":
    (path, argv), "curve": (path, argv), "eval": [(split, path, argv)]},
    and the run's directory and steps an epoch."""
    r = RECIPES[args.recipe]
    jax_args = script_args(r["command"], os.path.basename(
        r["train"]).replace("_torch", ""))
    val_flag = "--val_data" if "--val_data" in jax_args else "--eval_data"
    data_dir = os.path.join(args.work, "data")
    run_dir = os.path.join(args.work, f"{args.recipe}_{args.policy}"
                           + (f"_s{args.seed}" if args.seed is not None
                              else "")
                           + ("_cpu_data" if args.data_device == "cpu"
                              else "")
                           + ("_init" if args.init else "")
                           + ("_smoke" if args.smoke else ""))
    train_files = flag(jax_args, "--train_data").split(",")
    val_file = flag(jax_args, val_flag)
    train = with_flag(jax_args, "--data_folder", data_dir)
    train = with_flag(train, "--log_dir", run_dir)
    if args.smoke:
        files = [train_files[0]]
        train = with_flag(train, "--train_data", files[0])
        train = with_flag(train, val_flag, files[0])
    else:
        files = train_files + [val_file] + (
            [r["test_file"]] if r["test_file"] else [])
    if args.seed is not None:
        train = with_flag(train, "--seed", str(args.seed))
    train += ["--run_epochs", str(args.run_epochs)] + POLICIES[args.policy]
    if args.init:
        train += ["--resume", os.path.abspath(args.init)]
    elif args.continue_run:
        train += ["--resume", os.path.join(run_dir, "checkpoints")]
    steps = int(flag(train, "--pseudo_epoch_size")) // int(
        flag(train, "--batch_size_per_gpu"))

    regen = without_flags(
        script_args(r["regen"], os.path.basename(r["generate"]).replace(
            "_torch", "")), ("--seed", "--out"))
    if args.data_device != "cuda":
        regen = with_flag(regen, "--device", args.data_device)
    data = [(r["generate"], regen + ["--seed", str(seed_of(name)), "--out",
                                     os.path.join(data_dir, name)])
            for name in dict.fromkeys(files)]
    metrics = os.path.join(run_dir, "metrics.jsonl")
    curve = [metrics, "--steps_per_epoch", str(steps)]
    if args.smoke:
        curve.append("--keys_only")
    else:
        for ref in r["refs"]:
            curve += ["--ref", os.path.join(ROOT, ref)]
    evals = []
    if r["evaluate"] and not args.smoke:
        for split in ("val", "test"):
            evals.append((split, r["evaluate"], [
                "--ckpt", os.path.join(run_dir, "checkpoints"),
                "--data_folder", data_dir, "--split", split,
                "--eval_windows", "4", "--save_path",
                os.path.join(run_dir, f"eval_{split}.npz")]))
    return {"data": data, "train": (r["train"], train),
            "curve": (CURVE, curve), "eval": evals}, run_dir, steps


def command_line(path, argv):
    return shlex.join(["python", path] + argv)


class _Tee:
    """A text stream writing to several."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


_MODULES = {}


def _module(path):
    """The module of the script at ``path`` (repo-relative), loaded once."""
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            os.path.basename(path)[:-3], os.path.join(ROOT, path))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def run_cli(path, argv, log_path):
    """``main(argv)`` of the CLI at ``path`` (repo-relative) in this
    process, its output printed and appended to ``log_path``: its return
    value."""
    mod = _module(path)
    print(f"$ {command_line(path, argv)}", flush=True)
    with open(log_path, "a") as log:
        with contextlib.redirect_stdout(_Tee(sys.stdout, log)):
            return mod.main(argv)


SKIP_LINE = re.compile(r"^epoch (\d+): non-finite (.*) — update\(s\) skipped")
RECOVERY_LINE = re.compile(r"^epoch (\d+): CLIFF RECOVERY — (.*)$")
RESUME_LINE = re.compile(r"^resumed from step (\d+) ")


def train_readings(lines, metrics, steps):
    """The skipped updates and recoveries the train CLI printed in
    ``lines`` (every sitting of the run), each with its epoch (0-based,
    as the CLI prints it), and the s/step of each sitting's epochs after
    its first, which builds and captures (``train/sec_per_step`` of
    metrics.jsonl; a sitting starts at step 0 or where the CLI printed
    that it resumed)."""
    skips = [{"epoch": int(m.group(1)), "what": m.group(2)}
             for m in map(SKIP_LINE.match, lines) if m]
    recoveries = [{"epoch": int(m.group(1)), "what": m.group(2)}
                  for m in map(RECOVERY_LINE.match, lines) if m]
    starts = {0} | {int(m.group(1)) for m in map(RESUME_LINE.match, lines)
                    if m}
    sps = []
    with open(metrics) as f:
        for line in f:
            rec = json.loads(line)
            if "train/sec_per_step" in rec and not any(
                    s < rec["step"] <= s + steps for s in starts):
                sps.append(rec["train/sec_per_step"])
    return skips, recoveries, sps


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--recipe", choices=sorted(RECIPES), required=True)
    p.add_argument("--policy", choices=sorted(POLICIES), default="f32")
    p.add_argument("--run_epochs", type=int, default=0,
                   help="epochs to train (default 2 under --smoke)")
    p.add_argument("--work", required=True,
                   help="directory of the data and the run (outside the "
                        "repo)")
    p.add_argument("--data_device", choices=("cuda", "cpu"), default="cuda",
                   help="where the data CLIs make the seeds: the card, or "
                        "the port's numpy copies (the pinned bytes)")
    p.add_argument("--init", default="",
                   help="an exported state to start from (the train CLI's "
                        "--resume), e.g. the JAX run's initial one")
    p.add_argument("--seed", type=int, default=None,
                   help="override the command.sh seed (init and batch "
                        "draws); names the run <recipe>_<policy>_s<N>")
    p.add_argument("--continue_run", action="store_true",
                   help="continue the run's directory from its newest "
                        "checkpoint for --run_epochs more epochs")
    p.add_argument("--smoke", action="store_true",
                   help="the first train seed as train and val data, the "
                        "curve's keys alone, no dense eval")
    p.add_argument("--dry_run", action="store_true",
                   help="print the command lines, run nothing")
    args = p.parse_args(argv)
    if args.run_epochs <= 0:
        if not args.smoke:
            raise SystemExit("--run_epochs N is needed (N > 0)")
        args.run_epochs = 2
    if args.continue_run and args.init:
        raise SystemExit("--continue_run resumes the run's own checkpoints; "
                         "--init starts a run")
    args.work = os.path.abspath(args.work)
    stages, run_dir, steps = plan(args)

    if args.dry_run:
        for path, a in stages["data"]:
            print(command_line(path, a))
        for key in ("train", "curve"):
            print(command_line(*stages[key]))
        for _, path, a in stages["eval"]:
            print(command_line(path, a))
        return {"stages": stages, "run_dir": run_dir,
                "steps_per_epoch": steps}

    metrics = os.path.join(run_dir, "metrics.jsonl")
    if args.continue_run and not os.path.exists(metrics):
        raise SystemExit(f"{metrics} is not there: no run to continue")
    if os.path.exists(metrics) and not args.continue_run:
        raise SystemExit(f"{metrics} exists: pick another --work or remove "
                         "the run's directory")
    os.makedirs(run_dir, exist_ok=True)
    log_path = os.path.join(run_dir, "from_scratch.log")
    out = {"recipe": args.recipe, "policy": args.policy,
           "run_epochs": args.run_epochs, "smoke": args.smoke,
           "seed": int(flag(stages["train"][1], "--seed")),
           "continued": args.continue_run, "steps_per_epoch": steps}

    # (a) data.
    t0 = time.perf_counter()
    made, skipped = 0, 0
    for path, a in stages["data"]:
        if os.path.exists(flag(a, "--out")):
            skipped += 1
            continue
        run_cli(path, a, log_path)
        made += 1
    out["data"] = {"files": len(stages["data"]), "made": made,
                   "skipped_existing": skipped,
                   "seconds": time.perf_counter() - t0}
    print(f"from_scratch data: {made} files made, {skipped} there already, "
          f"{out['data']['seconds']:.1f} s", flush=True)

    # (b) training.
    t0 = time.perf_counter()
    res = run_cli(*stages["train"], log_path)
    with open(log_path) as f:
        skips, recoveries, sps = train_readings(f.read().splitlines(),
                                                metrics, steps)
    finite = all(bool(v.isfinite().all())
                 for v in res["state"].params().values())
    # Every update the optimizer skipped, as its device counter holds it
    # at the end (the CLI prints an epoch only where its last step was).
    total_skipped = int(res["state"].opt_state["total_notfinite"])
    out["train"] = {
        "seconds": time.perf_counter() - t0, "step": res["step"],
        "epochs": len(res["epochs"]), "skipped_updates": skips,
        "optimizer_total_notfinite": total_skipped,
        "recoveries": recoveries, "params_finite": finite,
        "sec_per_step_after_first": sps,
        "sec_per_step_mean": float(np.mean(sps)) if sps else math.nan,
        "provenance": res["provenance"]}
    for s in skips:
        print(f"from_scratch skipped update(s) at epoch {s['epoch']}: "
              f"{s['what']}")
    for r in recoveries:
        print(f"from_scratch cliff recovery at epoch {r['epoch']}: "
              f"{r['what']}")
    print(f"from_scratch train: {len(res['epochs'])} epochs to step "
          f"{res['step']} in {out['train']['seconds']:.1f} s; skipped-update "
          f"epochs {len(skips)} (updates the optimizer skipped: "
          f"{total_skipped}), recoveries {len(recoveries)}; "
          f"{out['train']['sec_per_step_mean']:.6f} s/step over the "
          f"{len(sps)} epochs after each sitting's first; final parameters "
          f"finite: {finite}", flush=True)
    del res

    # (c) the curve.
    curve = run_cli(*stages["curve"], log_path)
    out["curve"] = curve["curve"]
    # No JAX run of the bf16 policy is committed: its band is reported.
    enforced = args.smoke or args.policy == "f32"

    # (d) the dense eval; the final model's band counts once the run has
    # reached the recipe's last epoch.
    final = RECIPES[args.recipe]["final_eval"]
    refs = jax_final_means(final) if final else {}
    epochs = int(flag(stages["train"][1], "--epochs"))
    whole = out["train"]["step"] == epochs * steps
    out["eval"] = {}
    for split, path, a in stages["eval"]:
        res = run_cli(path, a, log_path)
        vals = [float(v) for v in res["rel_l2"]]
        rec = {"rel_l2": vals}
        line = (f"from_scratch dense eval, {split}: rel_l2 "
                + " / ".join(f"{v:.5f}" for v in vals)
                + f" (mean {np.mean(vals):.5f})")
        if split in refs:
            rec.update(final_band(float(np.mean(vals)), refs[split], whole))
            line += (f"; JAX model {rec['jax_mean']:.5f}, band "
                     f"[{rec['band'][0]:.5f}, {rec['band'][1]:.5f}]: "
                     + ("inside" if rec["inside"] else "OUTSIDE")
                     + (" (held)" if whole else
                        f" (reported: the run stops at step "
                        f"{out['train']['step']} of {epochs * steps})"))
        out["eval"][split] = rec
        print(line, flush=True)
    final_ok = all(r["inside"] for r in out["eval"].values()
                   if r.get("held"))

    out["ok"] = bool(finite and final_ok
                     and (out["curve"]["ok"] or not enforced))
    print(f"from_scratch: curve "
          + ("keys only" if args.smoke else "held" if enforced else
             "reported, not held") + f", ok {out['ok']}", flush=True)
    with open(os.path.join(run_dir, "summary.json"), "w") as f:
        json.dump(out, f)
    print(json.dumps({"from_scratch": out}), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main().get("ok", True) else 1)
