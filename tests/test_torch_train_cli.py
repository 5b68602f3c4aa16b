"""The port's training CLI (``experiments/rb2d/train_torch.py``) on the
CPU at a tiny size: two epochs, then a resume that continues at epoch 2
step-exact, with the per-epoch line, checkpoints and metrics log. On
CPU tensors the kernels' plain twins run, so no launch is counted."""

import importlib.util
import json
import os

import numpy as np
import pytest

from space_time_pde_torch.data import save_npz, taylor_green_fields
from space_time_pde_torch.ops import fused_jet, fused_query

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _driver():
    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(ROOT, "experiments", "rb2d",
                                    "train_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flags(tmp_path, *extra):
    return ["--device", "cpu", "--data_folder", str(tmp_path),
            "--train_data", "tg.npz", "--eval_data", "tg.npz", "--nt", "8",
            "--nz", "16", "--nx", "16", "--downsamp_t", "2",
            "--downsamp_xz", "4", "--n_samp_pts_per_crop", "32",
            "--lat_dims", "8", "--unet_nf", "4", "--imnet_nf", "2",
            "--pseudo_epoch_size", "8", "--batch_size_per_gpu", "2",
            "--inner_steps", "2", "--alpha_pde", "0.05", "--rayleigh", "100",
            "--lr", "2e-3", "--lr_schedule", "cosine",
            "--pde_loss_type", "huber",
            "--log_dir", str(tmp_path / "log"), *extra]


def test_train_then_resume(tmp_path, capsys):
    save_npz(str(tmp_path / "tg.npz"),
             taylor_green_fields(nt=10, nz=16, nx=16))
    train_torch = _driver()
    fused_jet.reset_launches()
    fused_query.reset_launches()
    first = train_torch.main(_flags(tmp_path, "--epochs", "2"))
    out = capsys.readouterr().out
    assert "train provenance: device=cpu" in out and "tf32_matmul=False" \
        in out
    assert "epoch 1: loss=" in out
    assert [e["epoch"] for e in first["epochs"]] == [0, 1]
    assert first["step"] == 8            # 2 epochs x 4 steps
    assert all(np.isfinite(e["loss"]) and np.isfinite(e["eval/rel_l2"])
               for e in first["epochs"])
    ckpts = sorted(os.listdir(tmp_path / "log" / "checkpoints"))
    assert ckpts == ["ckpt_4.pt", "ckpt_8.pt"]

    resumed = train_torch.main(_flags(
        tmp_path, "--epochs", "3", "--resume",
        str(tmp_path / "log" / "checkpoints")))
    out = capsys.readouterr().out
    assert "resumed from step 8 (epoch 2)" in out
    assert resumed["start_epoch"] == 2 and resumed["step"] == 12
    assert [e["epoch"] for e in resumed["epochs"]] == [2]
    assert fused_jet.LAUNCHES == {"jet_fwd": 0, "jet_bwd": 0,
                                  "jet_fwd_bf16": 0, "jet_bwd_bf16": 0}
    assert fused_query.LAUNCHES == {"decode_blend_gather": 0,
                                    "decode_blend": 0,
                                    "decode_blend_gather_bf16": 0,
                                    "decode_blend_bf16": 0}
    with open(tmp_path / "log" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "train/loss" in r] == [4, 8, 12]


def test_host_pipeline_and_config_errors(tmp_path):
    save_npz(str(tmp_path / "tg.npz"),
             taylor_green_fields(nt=10, nz=16, nx=16))
    train_torch = _driver()
    res = train_torch.main(_flags(tmp_path, "--epochs", "1",
                                  "--device_data", "false",
                                  "--inner_steps", "1"))
    assert "batch_assembly=host" in res["provenance"]
    assert res["step"] == 4
    with pytest.raises(SystemExit, match="pde_system"):
        train_torch.main(_flags(tmp_path, "--pde_system", "nope"))
    with pytest.raises(SystemExit, match="velonly"):
        train_torch.main(_flags(tmp_path, "--velonly", "true"))


def test_profile_epoch_logs_the_spans(tmp_path, capsys):
    """--profile_epoch 0 turns the port's spans on before the first
    dispatch: after epoch 0 the CLI prints and logs each span's device ms
    a step (on the CPU, the host's) as ``profile/<span>_ms``, and turns
    them off again."""
    from space_time_pde_torch.utils import tracing

    save_npz(str(tmp_path / "tg.npz"),
             taylor_green_fields(nt=10, nz=16, nx=16))
    train_torch = _driver()
    train_torch.main(_flags(tmp_path, "--epochs", "2",
                            "--profile_epoch", "0"))
    assert not tracing.enabled()
    with open(tmp_path / "log" / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    profile = [r for r in logged if any(k.startswith("profile/") for k in r)]
    assert len(profile) == 1 and profile[0]["step"] == 4
    names = ("step", "batch", "encode", "jet_fwd", "pde", "backward.pde",
             "backward.jet", "backward.encode", "optim")
    assert sorted(k for k in profile[0] if k.startswith("profile/")) == \
        sorted(f"profile/{n}_ms" for n in names)
    assert all(profile[0][f"profile/{n}_ms"] >= 0 for n in names)
    assert profile[0]["profile/step_ms"] >= sum(
        profile[0][f"profile/{n}_ms"] for n in names[1:])
    out = capsys.readouterr().out
    assert "epoch 0: device ms a step: step=" in out
    assert "torch.profiler trace of epoch_0" in out


def test_profile_epoch_and_debug_nans(tmp_path, capsys):
    """--profile_epoch writes a torch.profiler trace of that epoch;
    --debug_nans stops at the first step with a non-finite loss term
    (here an infinite point of the training field) and names it."""
    save_npz(str(tmp_path / "tg.npz"),
             taylor_green_fields(nt=10, nz=16, nx=16))
    train_torch = _driver()
    res = train_torch.main(_flags(tmp_path, "--epochs", "2",
                                  "--profile_epoch", "1", "--debug_nans"))
    assert res["step"] == 8
    trace = tmp_path / "log" / "profile" / "epoch_1.json"
    with open(trace) as f:
        assert "traceEvents" in json.load(f)
    assert "torch.profiler trace of epoch_1" in capsys.readouterr().out

    fields = taylor_green_fields(nt=10, nz=16, nx=16)
    fields["u"] = np.full_like(fields["u"], np.inf)
    save_npz(str(tmp_path / "bad.npz"), fields)
    flags = _flags(tmp_path, "--epochs", "1", "--debug_nans",
                   "--device_data", "false", "--inner_steps", "1",
                   "--log_dir", str(tmp_path / "log_bad"))
    flags[flags.index("tg.npz")] = "bad.npz"
    with pytest.raises(FloatingPointError, match="non-finite loss term "
                       "'reg_loss' at step 0"):
        train_torch.main(flags)
