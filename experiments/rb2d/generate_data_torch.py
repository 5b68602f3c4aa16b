"""Generate RB2D training data on the PyTorch / CUDA port (CLI).

Counterpart of ``experiments/rb2d/generate_data.py``: the same flags,
the same npz schema and the same ``wrote ...`` line, plus ``--device``.
On ``cuda`` (the default) the float64 Boussinesq solver runs on the
card (``space_time_pde_torch/data/rb2_solver.py``: cuFFT for the x
derivatives, the hand-written batched tridiagonal kernel
``csrc/tridiag.cu`` for the Helmholtz solves, the steps between two
snapshots replayed as one CUDA graph). On ``cpu`` it runs the port's
numpy copy of the solver (``space_time_pde_torch/data/generator.py``),
which writes the very files that ``data/SHA256SUMS.rb2d`` pins. The
last line gives the seconds the seed took and where it ran.

Example (the flags of ``data/regen_rb2d.sh``, on a card):
    python experiments/rb2d/generate_data_torch.py --nx 512 --nz 128 \
        --rayleigh 1e6 --n_snapshots 200 --seed 42 \
        --out data/rb2d_ra1e6_s42.npz
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch

from space_time_pde_torch.data import generator


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", type=str, default="data/rb2d_ra1e6_s42.npz")
    p.add_argument("--kind", type=str, default="rb2d",
                   choices=["rb2d", "taylor_green"])
    p.add_argument("--nx", type=int, default=512)
    p.add_argument("--nz", type=int, default=128)
    p.add_argument("--lx", type=float, default=4.0)
    p.add_argument("--lz", type=float, default=1.0)
    p.add_argument("--rayleigh", type=float, default=1e6)
    p.add_argument("--prandtl", type=float, default=1.0)
    p.add_argument("--t_transient", type=float, default=25.0)
    p.add_argument("--n_snapshots", type=int, default=200)
    p.add_argument("--snap_dt", type=float, default=0.125)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--nt", type=int, default=64, help="taylor_green frames")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the rb2d solver; 'cpu' runs the "
                        "numpy copy of the solver")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device here; --device cpu runs the numpy "
                         "solver")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    t0 = time.perf_counter()
    if args.kind == "taylor_green":
        fields = generator.taylor_green_fields(nt=args.nt, nz=args.nz,
                                               nx=args.nx)
    else:
        kw = dict(nx=args.nx, nz=args.nz, lx=args.lx, lz=args.lz,
                  rayleigh=args.rayleigh, prandtl=args.prandtl,
                  t_transient=args.t_transient,
                  n_snapshots=args.n_snapshots, snap_dt=args.snap_dt,
                  seed=args.seed, progress=True)
        if device.type == "cpu":
            fields = generator.simulate_rb2d(**kw)
        else:
            from space_time_pde_torch.data.rb2_solver import simulate_rb2d
            fields = simulate_rb2d(device=device, **kw)
    seconds = time.perf_counter() - t0
    generator.save_npz(args.out, fields)
    print(f"wrote {args.out}: "
          + ", ".join(f"{k}{v.shape}" for k, v in fields.items()
                      if hasattr(v, "shape") and v.ndim > 0))
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (numpy)")
    print(f"seed {args.seed}: {seconds:.1f} s on {where}", flush=True)


if __name__ == "__main__":
    main()
