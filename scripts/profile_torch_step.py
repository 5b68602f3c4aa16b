"""Where a training step's device time goes, on the card.

Builds the step of ``space_time_pde_torch/assets/<recipe>_train_step_ref
.npz`` as ``chip_smoke.py`` does (the seeded weights and batch that it
holds against JAX: the rb2d flagship or the ``r5_turb3d_200x_big``
recipe), times
``--steps`` steps after ``--warm`` warm ones with a host clock ended by a
device synchronise, then runs the same number under ``torch.profiler``
and prints the kernels by summed device time, the kernel time a step
and the idle share (1 - kernel time / unprofiled wall time), with the
card's name and power limit. Needs a CUDA device.

    python scripts/profile_torch_step.py --recipe turb3d
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch

from chip_smoke import ASSETS, reference_step


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--recipe", choices=("rb2d", "turb3d"),
                        default="turb3d")
    parser.add_argument("--warm", type=int, default=5)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--top", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    step, state, batch, _, _ = reference_step(
        os.path.join(ASSETS, f"{args.recipe}_train_step_ref.npz"), device)
    for _ in range(args.warm):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
    rows.sort(key=dev, reverse=True)
    total = sum(dev(e) for e in rows) / 1e3 / args.steps
    print(f"{args.recipe} step on {card}: {wall * 1e3:.2f} ms/step "
          f"unprofiled; {total:.2f} ms of kernel time a step; idle share "
          f"{1 - total / (wall * 1e3):.3f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    for e in rows[:args.top]:
        ms = dev(e) / 1e3 / args.steps
        print(f"  {ms:9.3f} ms/step {100 * ms / total:5.1f}%  "
              f"{e.count // args.steps:6d} launches/step  {e.key[:90]}")


if __name__ == "__main__":
    main()
