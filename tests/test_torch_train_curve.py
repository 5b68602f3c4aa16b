"""``scripts/train_curve.py`` (a run's curve against the JAX runs'
committed curves, window by window) and ``scripts/train_from_scratch.py``
(one command a from-scratch run: data, training, curve, dense eval).

The curve reader's window medians of the two committed rb2d flagship runs
(``log/r{4,5}_rb2d_4x_e900/metrics.jsonl``) are the ones its band is built
from; a run scaled out of the band fails at the window it leaves; a NaN
gradient norm is reported. The from-scratch command lines carry every flag of
the JAX runs' ``command.sh`` with only ``--data_folder`` and
``--log_dir`` moved, and a tiny recipe runs its stages end to end on the
CPU. The turb3d CLI's ``--run_epochs`` keeps the schedule of
``--epochs``, and ``scripts/export_jax_turb3d_init.py`` hands the port the
JAX driver's initial state bit for bit.
"""

import argparse
import importlib.util
import json
import math
import os
import shlex

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(ROOT, "log", "r4_rb2d_4x_e900", "metrics.jsonl")
R5 = os.path.join(ROOT, "log", "r5_rb2d_4x_e900", "metrics.jsonl")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# Window medians of eval/rel_l2 and train/loss, r4 / r5, epochs 1-60.
WANT = {(1, 10): ((0.0494, 0.0450), (0.0419, 0.0393)),
        (11, 20): ((0.0362, 0.0359), (0.0319, 0.0327)),
        (21, 30): ((0.0308, 0.0327), (0.0268, 0.0280)),
        (31, 40): ((0.0273, 0.0277), (0.0248, 0.0238)),
        (41, 60): ((0.0276, 0.0266), (0.0236, 0.0242))}


def test_window_medians_of_the_committed_rb2d_runs():
    tc = _script("train_curve")
    r4, r5 = (tc.load_epochs(p, 256) for p in (R4, R5))
    assert sorted(r4) == list(range(1, 901))
    rows = {tuple(r["window"]): r for r in tc.curve(r4, {"r4": r4,
                                                         "r5": r5})}
    for window, (rel, loss) in WANT.items():
        row = rows[window]
        for key, want in (("eval/rel_l2", rel), ("train/loss", loss)):
            got = (row[key]["refs"]["r4"], row[key]["refs"]["r5"])
            assert [round(v, 4) for v in got] == list(want), (window, key)
        assert row["max_grad_norm"] <= 1.65
    assert not rows[(1, 10)]["held"] and rows[(11, 20)]["held"]


def test_r4_held_against_r4_and_r5_passes(capsys):
    out = _script("train_curve").main([R4, "--ref", R4, "--ref", R5,
                                       "--steps_per_epoch", "256"])
    assert out["curve"]["ok"]
    assert [w["window"] for w in out["curve"]["windows"]][-1] == [121, 150]
    last = capsys.readouterr().out.splitlines()[-1]
    assert json.loads(last)["curve"]["ok"]


def _rewrite(src, dst, edit):
    with open(src) as f, open(dst, "w") as g:
        for line in f:
            rec = json.loads(line)
            edit(rec)
            g.write(json.dumps(rec) + "\n")


def test_scaled_eval_fails_at_window_11_20(tmp_path):
    scaled = tmp_path / "metrics.jsonl"

    def edit(rec):
        if "eval/rel_l2" in rec:
            rec["eval/rel_l2"] *= 1.5

    _rewrite(R4, scaled, edit)
    out = _script("train_curve").main([str(scaled), "--ref", R4, "--ref",
                                       R5, "--steps_per_epoch", "256"])
    assert not out["curve"]["ok"]
    first_bad = next(w for w in out["curve"]["windows"] if not w["ok"])
    assert first_bad["window"] == [11, 20]
    assert not first_bad["eval/rel_l2"]["inside"]
    assert first_bad["train/loss"]["inside"]
    # Window 1-10 is out of the band too, and reported, not held.
    w1 = out["curve"]["windows"][0]
    assert w1["ok"] and not w1["held"]


def test_nan_grad_norm_is_reported(tmp_path, capsys):
    tc = _script("train_curve")
    run = tmp_path / "metrics.jsonl"

    def edit(rec):
        if rec["step"] == 15 * 256 and "train/grad_norm" in rec:
            rec["train/grad_norm"] = float("nan")

    _rewrite(R4, run, edit)
    out = tc.main([str(run), "--ref", R4, "--ref", R5,
                   "--steps_per_epoch", "256"])
    w = out["curve"]["windows"][1]
    assert math.isnan(w["max_grad_norm"])
    assert [f["epoch"] for f in w["flagged"]] == [15]
    assert "grad_norm nan" in w["flagged"][0]["why"]
    assert "epoch 15: grad_norm nan" in capsys.readouterr().out
    keys = tc.main([str(run), "--steps_per_epoch", "256", "--keys_only"])
    assert not keys["curve"]["ok"]
    assert keys["curve"]["bad"] == [(15, ["train/grad_norm"])]


def test_loss_spikes_are_counted_as_events(tmp_path):
    """Synthetic metrics, one step an epoch: epochs with train/loss above
    SPIKE_LOSS, consecutive ones one event, for the run and for each
    reference up to the run's last epoch."""
    tc = _script("train_curve")

    def write(path, losses):
        with open(path, "w") as f:
            for e, loss in enumerate(losses, 1):
                f.write(json.dumps({"step": e, "train/loss": loss,
                                    "train/grad_norm": 1.0}) + "\n")
                f.write(json.dumps({"step": e, "eval/rel_l2": 0.05}) + "\n")

    run, ref = tmp_path / "run" / "metrics.jsonl", \
        tmp_path / "ref" / "metrics.jsonl"
    run.parent.mkdir(), ref.parent.mkdir()
    write(run, [0.9, 0.1, 0.5, 0.31, 0.1, 0.3, 0.2, float("nan"), 0.1])
    write(ref, [0.1, 0.4, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 7.0])
    out = tc.main([str(run), "--ref", str(ref), "--steps_per_epoch", "1"])
    spikes = out["curve"]["spikes"]
    assert tc.SPIKE_LOSS == 0.3 and spikes["loss_above"] == 0.3
    assert spikes["run"] == [[1, 1], [3, 4], [8, 8]]
    assert spikes["to_epoch"] == 9
    assert spikes["refs"] == {"ref": [[2, 2]]}


def _command_flags(recipe_log):
    with open(os.path.join(ROOT, "log", recipe_log, "command.sh")) as f:
        text = f.read().replace("\\\n", " ")
    tokens = shlex.split(text.split("train.py", 1)[1])
    return dict(zip(tokens[::2], tokens[1::2]))


@pytest.mark.parametrize("policy", ["f32", "use_bf16_pde_bf16"])
@pytest.mark.parametrize("recipe,recipe_log,seeds", [
    ("rb2d", "r5_rb2d_4x_e900", {42, 100, 101, 102, 7, 123}),
    ("turb3d", "r5_turb3d_200x_big", {42, 7} | set(range(100, 300)))])
def test_dry_run_carries_every_flag_of_command_sh(tmp_path, recipe,
                                                  recipe_log, seeds, policy):
    tfs = _script("train_from_scratch")
    work = str(tmp_path / "w")
    out = tfs.main(["--recipe", recipe, "--policy", policy, "--run_epochs",
                    "3", "--work", work, "--dry_run"])
    path, argv = out["stages"]["train"]
    assert path == f"experiments/{recipe}/train_torch.py"
    got = dict(zip(argv[::2], argv[1::2]))
    want = _command_flags(recipe_log)
    moved = {"--data_folder": os.path.join(work, "data"),
             "--log_dir": out["run_dir"]}
    extra = {"--run_epochs": "3"}
    if policy != "f32":
        extra.update({"--use_bf16": "true", "--pde_bf16": "true"})
    assert got == {**want, **moved, **extra}
    assert out["run_dir"].startswith(work)
    assert out["steps_per_epoch"] == (256 if recipe == "rb2d" else 512)
    made = [int(a[a.index("--seed") + 1]) for _, a in out["stages"]["data"]]
    assert len(made) == len(set(made)) and set(made) == seeds
    if recipe == "rb2d":
        _, regen = out["stages"]["data"][0]
        assert regen[:8] == ["--nx", "512", "--nz", "128", "--rayleigh",
                             "1e6", "--n_snapshots", "200"]
    assert [a[a.index("--split") + 1]
            for _, _, a in out["stages"]["eval"]] == ["val", "test"]


def test_turb3d_dry_run_prints_the_dense_eval_of_both_splits(tmp_path,
                                                             capsys):
    """Stage (d) of ``--recipe turb3d``: the turb3d eval CLI on the run's
    checkpoints, val and test, 4 windows each (the protocol of the
    committed JAX eval log); the data stage makes the test seed 123 with
    ``regen_beltrami.sh``'s flags, as every other seed."""
    tfs = _script("train_from_scratch")
    work = str(tmp_path / "w")
    out = tfs.main(["--recipe", "turb3d", "--run_epochs", "150", "--work",
                    work, "--dry_run"])
    printed = capsys.readouterr().out.splitlines()
    run = out["run_dir"]
    for split in ("val", "test"):
        want = ("python experiments/turb3d/evaluation_torch.py --ckpt "
                f"{run}/checkpoints --data_folder {work}/data --split "
                f"{split} --eval_windows 4 --save_path {run}/eval_{split}.npz")
        assert want in printed
    with open(os.path.join(ROOT, tfs.RECIPES["turb3d"]["final_eval"])) as f:
        protocol = f.readlines()[1]
    assert "--split SPLIT --eval_windows 4" in protocol
    regen = tfs.without_flags(tfs.script_args(
        "data/regen_beltrami.sh", "generate_data.py"), ("--seed", "--out"))
    made = {int(a[a.index("--seed") + 1]): a for _, a in out["stages"]["data"]}
    assert made[123] == regen + ["--seed", "123", "--out",
                                 os.path.join(work, "data",
                                              "beltrami_s123.npz")]
    assert all(a[:len(regen)] == regen for a in made.values())


def test_seed_reaches_the_train_cli_and_names_the_run(tmp_path):
    tfs = _script("train_from_scratch")
    work = str(tmp_path / "w")
    out = tfs.main(["--recipe", "turb3d", "--run_epochs", "45", "--work",
                    work, "--seed", "43", "--dry_run"])
    _, argv = out["stages"]["train"]
    assert argv.count("--seed") == 1
    assert argv[argv.index("--seed") + 1] == "43"
    assert out["run_dir"] == os.path.join(work, "turb3d_f32_s43")
    assert argv[argv.index("--log_dir") + 1] == out["run_dir"]
    plain = tfs.main(["--recipe", "turb3d", "--run_epochs", "45", "--work",
                      work, "--dry_run"])
    _, argv = plain["stages"]["train"]
    assert argv[argv.index("--seed") + 1] == "42"
    assert plain["run_dir"] == os.path.join(work, "turb3d_f32")
    cont = tfs.main(["--recipe", "turb3d", "--run_epochs", "75", "--work",
                     work, "--seed", "42", "--continue_run", "--dry_run"])
    _, argv = cont["stages"]["train"]
    assert argv[argv.index("--resume") + 1] == os.path.join(
        cont["run_dir"], "checkpoints")
    with pytest.raises(SystemExit, match="--init starts a run"):
        tfs.main(["--recipe", "turb3d", "--run_epochs", "1", "--work", work,
                  "--continue_run", "--init", "x.npz", "--dry_run"])


def test_scaled_final_eval_fails_the_band():
    """The final model's band: each split's mean within [CURVE_LOW,
    CURVE_HIGH] x the JAX model's mean in the committed eval log (val
    0.00607, test 0.00722); held only once the run reached the recipe's
    last epoch."""
    tfs = _script("train_from_scratch")
    refs = tfs.jax_final_means(tfs.RECIPES["turb3d"]["final_eval"])
    assert refs == {"val": 0.00607, "test": 0.00722}
    for split, ref in refs.items():
        band = tfs.final_band(ref, ref, True)
        assert band["inside"] and band["band"] == pytest.approx(
            [0.8 * ref, 1.25 * ref])
        scaled = tfs.final_band(1.5 * ref, ref, True)
        assert not scaled["inside"] and scaled["held"]
        assert not tfs.final_band(0.75 * ref, ref, True)["inside"]
        assert not tfs.final_band(1.5 * ref, ref, False)["held"]


TINY_COMMAND = """cd /somewhere
python experiments/rb2d/train.py --data_folder data \\
  --train_data rb2d_ra1e6_s42.npz,rb2d_ra1e6_s100.npz \\
  --val_data rb2d_ra1e6_s7.npz --device cpu \\
  --nt 8 --nz 16 --nx 32 --downsamp_t 2 --downsamp_xz 4 \\
  --lat_dims 4 --unet_nf 4 --imnet_nf 4 --n_samp_pts_per_crop 32 \\
  --batch_size_per_gpu 2 --inner_steps 2 --pseudo_epoch_size 8 \\
  --alpha_pde 0.1 --lr 5e-3 --lr_schedule cosine --pde_loss_type huber \\
  --epochs 10 --seed 42 --log_dir log/tiny
"""
TINY_REGEN = """f=data/rb2d_ra1e6_s${S}.npz
python experiments/rb2d/generate_data.py --nx 32 --nz 16 \\
  --rayleigh 1e4 --t_transient 0.5 --n_snapshots 12 --snap_dt 0.25 \\
  --device cpu --seed $S --out "$f" || exit 1
"""


def test_smoke_runs_its_stages_on_the_cpu(tmp_path, monkeypatch):
    """A tiny recipe (its command.sh and regen script in ``tmp_path``,
    every CLI on the CPU) through ``--smoke``: one seed made, 2 epochs
    trained, the curve's keys checked, the summary written."""
    tfs = _script("train_from_scratch")
    (tmp_path / "command.sh").write_text(TINY_COMMAND)
    (tmp_path / "regen.sh").write_text(TINY_REGEN)
    monkeypatch.setitem(tfs.RECIPES, "rb2d", dict(
        tfs.RECIPES["rb2d"], command=str(tmp_path / "command.sh"),
        regen=str(tmp_path / "regen.sh")))
    work = tmp_path / "work"
    out = tfs.main(["--recipe", "rb2d", "--work", str(work), "--smoke"])
    assert out["ok"] and out["data"]["made"] == 1
    assert out["train"]["step"] == 8 and out["train"]["params_finite"]
    assert out["train"]["skipped_updates"] == []
    assert out["train"]["optimizer_total_notfinite"] == 0
    assert out["curve"]["keys_only"] and out["curve"]["epochs"] == 2
    assert len(out["train"]["sec_per_step_after_first"]) == 1
    run = work / "rb2d_f32_smoke"
    assert json.loads((run / "summary.json").read_text())["ok"]
    log = (run / "from_scratch.log").read_text()
    assert "epoch 1: loss=" in log and "curve keys:" in log
    # A second run into the same directory is refused; the data is kept.
    with pytest.raises(SystemExit, match="exists"):
        tfs.main(["--recipe", "rb2d", "--work", str(work), "--smoke"])
    assert np.load(work / "data" / "rb2d_ra1e6_s42.npz")["b"].shape == \
        (12, 16, 32)


def test_train_readings_parse_the_cli_lines(tmp_path):
    tfs = _script("train_from_scratch")
    metrics = tmp_path / "metrics.jsonl"
    metrics.write_text("\n".join(json.dumps(r) for r in (
        {"step": 4, "train/sec_per_step": 1.0},
        {"step": 8, "train/sec_per_step": 0.25},
        {"step": 8, "eval/rel_l2": 0.5},
        {"step": 12, "train/sec_per_step": 0.5})) + "\n")
    lines = ["epoch 3: non-finite ['grad_norm', 'loss'] — update(s) skipped "
             "(apply_if_finite), params healthy; device buffers "
             "re-uploaded, continuing",
             "epoch 5: CLIFF RECOVERY — loss explosion: 1e7; restored step "
             "16, continuing with lr x0.5",
             "epoch 6: loss=0.1 reg=0.1 pde=0.1 eval_rel_l2=0.1 (0.1s/step)"]
    skips, recoveries, sps = tfs.train_readings(lines, metrics, 4)
    assert [s["epoch"] for s in skips] == [3]
    assert [r["epoch"] for r in recoveries] == [5]
    assert "loss explosion" in recoveries[0]["what"]
    assert sps == [0.25, 0.5]
    # A run continued from step 8: its sitting's first epoch (step 12)
    # builds and captures again, and is left out as the run's first is.
    resumed = lines + ["resumed from step 8 (epoch 2)"]
    assert tfs.train_readings(resumed, metrics, 4)[2] == [0.25]


def test_turb3d_run_epochs_keeps_the_schedule(tmp_path):
    """``--run_epochs N`` on the turb3d CLI (as on the rb2d one) stops after
    N epochs of the schedule that ``--epochs`` spans: the same epochs as
    the first N of the whole run, bit for bit."""
    from space_time_pde_torch.data import beltrami_fields, save_npz

    for seed in (42, 7):
        save_npz(str(tmp_path / f"beltrami_s{seed}.npz"),
                 beltrami_fields(seed, nt=10, n=8))
    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(ROOT, "experiments", "turb3d",
                                    "train_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    flags = ["--device", "cpu", "--data_folder", str(tmp_path),
             "--train_data", "beltrami_s42.npz", "--eval_data",
             "beltrami_s7.npz", "--nt", "8", "--nz", "8", "--ny", "8",
             "--nx", "8", "--downsamp_t", "2", "--downsamp_xyz", "4",
             "--lat_dims", "4", "--unet_nf", "2", "--unet_mf", "8",
             "--imnet_nf", "2", "--n_samp_pts_per_crop", "16",
             "--batch_size_per_gpu", "2", "--pseudo_epoch_size", "4",
             "--inner_steps", "2", "--alpha_pde", "0.1", "--lr", "5e-3",
             "--lr_schedule", "cosine", "--epochs", "3"]
    whole = cli.main(flags + ["--log_dir", str(tmp_path / "a")])
    part = cli.main(flags + ["--log_dir", str(tmp_path / "b"),
                             "--run_epochs", "2"])
    assert [e["epoch"] for e in part["epochs"]] == [0, 1]
    assert part["step"] == 4 and whole["step"] == 6
    for a, b in zip(whole["epochs"], part["epochs"]):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]


def test_fault_options_in_the_command_lines(tmp_path):
    """``--data_device cpu`` makes the seeds with the numpy copies and
    ``--init FILE`` resumes the train CLI from FILE; each names the run."""
    tfs = _script("train_from_scratch")
    init = tmp_path / "init.npz"
    out = tfs.main(["--recipe", "turb3d", "--run_epochs", "30", "--work",
                    str(tmp_path), "--data_device", "cpu", "--init",
                    str(init), "--dry_run"])
    assert out["run_dir"] == str(tmp_path / "turb3d_f32_cpu_data_init")
    assert all(a[a.index("--device") + 1] == "cpu"
               for _, a in out["stages"]["data"])
    _, argv = out["stages"]["train"]
    assert argv[argv.index("--resume") + 1] == str(init)
    assert out["stages"]["curve"][1][0] == os.path.join(out["run_dir"],
                                                        "metrics.jsonl")


TINY_TURB3D = """python experiments/turb3d/train.py --data_folder data \\
  --train_data beltrami_s42.npz --eval_data beltrami_s7.npz \\
  --nt 8 --nz 8 --ny 8 --nx 8 --downsamp_t 2 --downsamp_xyz 4 \\
  --lat_dims 4 --unet_nf 2 --unet_mf 8 --imnet_nf 2 \\
  --n_samp_pts_per_crop 16 --batch_size_per_gpu 2 --inner_steps 2 \\
  --pseudo_epoch_size 4 --alpha_pde 0.1 --lr 5e-3 --lr_schedule cosine \\
  --pde_loss_type huber --epochs 3 --seed 42 --log_dir log/tiny
"""


def test_jax_turb3d_init_export_resumes_in_the_port(tmp_path):
    """``scripts/export_jax_turb3d_init.py`` writes the JAX driver's
    initial state (its ``init_state4d`` at the run's seed): the port
    restores every parameter of it bit for bit, at step 0 with zero
    moments, and its turb3d CLI starts there (epoch 0)."""
    import jax

    from space_time_pde_torch.bridge import flatten_tree, load_exported
    from space_time_pde_torch.data import beltrami_fields, save_npz
    from space_time_pde_torch.train import (build_models, init_state,
                                            make_optimizer)
    from space_time_pde_torch.utils.checkpoint import restore_exported

    (tmp_path / "command.sh").write_text(TINY_TURB3D)
    out = tmp_path / "init.npz"
    _script("export_jax_turb3d_init").main([
        "--command", str(tmp_path / "command.sh"), "--out", str(out)])
    spec = importlib.util.spec_from_file_location(
        "jax_turb3d_train", os.path.join(ROOT, "experiments", "turb3d",
                                         "train.py"))
    drv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drv)
    tfs = _script("train_from_scratch")
    flags = tfs.script_args(str(tmp_path / "command.sh"), "train.py")
    p = argparse.ArgumentParser()
    drv.add_turb3d_args(p)
    run = p.parse_args(flags)
    unet, imnet = drv.build_turb3d_models(run, (4, 2, 2, 2))
    want = drv.init_state4d(jax.random.PRNGKey(42), run, unet, imnet,
                            drv.make_optimizer(drv.make_config(run), 2),
                            (4, 2, 2, 2)).params

    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(ROOT, "experiments", "turb3d",
                                    "train_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cfg = cli.make_config(p.parse_args(flags))
    tu, ti = build_models(cfg, (4, 2, 2, 2), "cpu")
    state = init_state(0, tu, ti, make_optimizer(cfg, 2))
    state, extra = restore_exported(state, str(out))
    assert state.step == 0 and extra["epoch"] == -1
    assert all(float(v.abs().max()) == 0.0
               for m in ("mu", "nu") for v in state.opt_state[m].values())
    got = flatten_tree(load_exported(str(out))["params"])
    ref = flatten_tree(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])

    for seed in (42, 7):
        save_npz(str(tmp_path / f"beltrami_s{seed}.npz"),
                 beltrami_fields(seed, nt=10, n=8))
    res = cli.main(flags[:1] + [str(tmp_path)] + flags[2:] + [
        "--device", "cpu", "--log_dir", str(tmp_path / "log"), "--resume",
        str(out), "--run_epochs", "1"])
    assert res["start_epoch"] == 0 and res["step"] == 2
