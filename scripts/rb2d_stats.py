"""Write the statistics of the canonical rb2d datasets (the port's asset).

Reads rb2d npz files (``experiments/rb2d/generate_data_torch.py --device
cpu`` or ``generate_data.py`` output; seeds 42 and 7 by default), checks
each against ``data/SHA256SUMS.rb2d``, and writes, per seed,
``data/rb2_solver.py::flow_statistics``: the x-and-time mean profile of
``b``, the rms profiles of ``u`` and ``w`` and the time-mean Nusselt
number at each wall, to ``space_time_pde_torch/assets/
rb2d_ra1e6_stats.npz`` (``seeds``, ``<stat>`` stacked over the seeds,
``sha256`` of each file). ``chip_smoke.py`` holds a card run's seed
against them; the datasets themselves stay out of the repo.

    python scripts/rb2d_stats.py --data data/rb2d_ra1e6_s42.npz \
        data/rb2d_ra1e6_s7.npz
"""

import argparse
import hashlib
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

from space_time_pde_torch.data.rb2_solver import flow_statistics

OUT = os.path.join(ROOT, "space_time_pde_torch", "assets",
                   "rb2d_ra1e6_stats.npz")
SUMS = os.path.join(ROOT, "data", "SHA256SUMS.rb2d")


def pinned() -> dict:
    """{file name: sha256} of ``data/SHA256SUMS.rb2d``."""
    with open(SUMS) as f:
        return {os.path.basename(name): digest for digest, name in
                (line.split() for line in f if line.strip())}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", nargs="+",
                   default=[os.path.join(ROOT, "data", f"rb2d_ra1e6_s{s}.npz")
                            for s in (42, 7)])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)

    sums = pinned()
    seeds, digests, stats = [], [], []
    for path in args.data:
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        name = os.path.basename(path)
        if sums.get(name) != digest:
            raise SystemExit(f"{path}: sha256 {digest} is not "
                             f"data/SHA256SUMS.rb2d's {sums.get(name)}")
        seeds.append(int(re.search(r"_s(\d+)\.npz$", name).group(1)))
        digests.append(digest)
        with np.load(path) as z:
            stats.append(flow_statistics(z))
        print(f"{name}: sha256 pinned; Nu bottom "
              f"{stats[-1]['nu_bottom']:.6f} top {stats[-1]['nu_top']:.6f}, "
              f"max u_rms {stats[-1]['u_rms'].max():.6f} w_rms "
              f"{stats[-1]['w_rms'].max():.6f}", flush=True)
    np.savez(args.out, seeds=np.array(seeds), sha256=np.array(digests),
             **{k: np.stack([s[k] for s in stats]) for k in stats[0]})
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
