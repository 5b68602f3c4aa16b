"""Generate the turb3d Beltrami data on the PyTorch / CUDA port (CLI).

Counterpart of ``experiments/turb3d/generate_data.py``: the same flags,
the same npz schema and the same ``beltrami realization ...`` and
``wrote ...`` lines, plus ``--device``. Each file is the exact decaying
ABC (Beltrami) Navier–Stokes solution ``abc_flow_fields`` documents,
for ``--seed``'s realization (``beltrami_realization_params``) or the
``--abc`` amplitudes. On ``cuda`` (the default) the closed form is
evaluated with torch on the card in float64 and cast once to float32,
as the numpy copy casts; each field lies within 2^-22 of its max |value|
from the numpy copy's (sin, cos and exp round otherwise on the card).
On ``cpu`` it runs the port's numpy copy
(``space_time_pde_torch/data/generator.py``), which writes the very
files that ``data/SHA256SUMS.beltrami`` pins. The last line gives the
seconds the file took and where it ran.

Example (one realization of the turb3d recipe, on a card):
    python experiments/turb3d/generate_data_torch.py --seed 42 \
        --out data/beltrami_s42.npz
"""

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np
import torch

from space_time_pde_torch.data import generator


def abc_flow_fields_torch(nt, nz, ny, nx, viscosity, dt, A, B, C, phases,
                          device):
    """``generator.abc_flow_fields`` evaluated with torch on ``device`` in
    float64, the four fields cast once to float32 and returned as numpy
    arrays [T, Z, Y, X] beside the same float64 scalars."""
    f64 = dict(dtype=torch.float64, device=device)
    pz, px, py = phases
    # numpy's linspace(0, 2 pi, n, endpoint=False): arange(n) * (2 pi / n).
    t = (torch.arange(nt, **f64) * dt).view(-1, 1, 1, 1)
    z = (torch.arange(nz, **f64) * (2 * math.pi / nz)).view(1, -1, 1, 1)
    y = (torch.arange(ny, **f64) * (2 * math.pi / ny)).view(1, 1, -1, 1)
    x = (torch.arange(nx, **f64) * (2 * math.pi / nx)).view(1, 1, 1, -1)
    F = torch.exp(-viscosity * t)
    u = (A * torch.sin(z + pz) + C * torch.cos(y + py)) * F
    v = (B * torch.sin(x + px) + A * torch.cos(z + pz)) * F
    w = (C * torch.sin(y + py) + B * torch.cos(x + px)) * F
    shape = (nt, nz, ny, nx)
    u, v, w = (f.expand(shape) for f in (u, v, w))
    p = -0.5 * (u ** 2 + v ** 2 + w ** 2)
    out = {k: f.to(torch.float32).cpu().numpy()
           for k, f in (("p", p), ("u", u), ("v", v), ("w", w))}
    out.update(dt=np.float64(dt), dz=np.float64(2 * np.pi / nz),
               dy=np.float64(2 * np.pi / ny), dx=np.float64(2 * np.pi / nx),
               viscosity=np.float64(viscosity))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--kind", type=str, default="abc",
                        choices=("abc",))
    parser.add_argument("--nt", type=int, default=24)
    parser.add_argument("--nz", type=int, default=32)
    parser.add_argument("--ny", type=int, default=32)
    parser.add_argument("--nx", type=int, default=32)
    parser.add_argument("--dt", type=float, default=0.1)
    parser.add_argument("--viscosity", type=float, default=1e-2)
    parser.add_argument("--abc", type=float, nargs=3,
                        default=(1.0, 0.7, 0.3),
                        help="A B C coefficients of the ABC flow")
    parser.add_argument(
        "--seed", type=int, default=None,
        help="random same-statistics Beltrami realization: amplitudes "
             "on the fixed-energy sphere + random phases (overrides "
             "--abc). Independent seeds are fully decorrelated exact "
             "NS solutions — the turb3d train/val/test protocol uses "
             "seeds 42/7/123 (data/splits.py::CANONICAL_SEEDS)")
    parser.add_argument("--out", type=str, default="abc_flow.npz")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the closed form; 'cpu' runs "
                             "the numpy copy")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device here; --device cpu runs the numpy "
                         "closed form")
    t0 = time.perf_counter()
    if args.seed is not None:
        a, b, c, phases = generator.beltrami_realization_params(args.seed)
        print(f"beltrami realization seed {args.seed}: "
              f"A={a:.3f} B={b:.3f} C={c:.3f} phases="
              + str([round(p, 3) for p in phases]))
    else:
        (a, b, c), phases = args.abc, (0.0, 0.0, 0.0)
    kw = dict(nt=args.nt, nz=args.nz, ny=args.ny, nx=args.nx,
              viscosity=args.viscosity, dt=args.dt, A=a, B=b, C=c,
              phases=phases)
    if device.type == "cpu":
        fields = generator.abc_flow_fields(**kw)
    else:
        fields = abc_flow_fields_torch(device=device, **kw)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    generator.save_npz(args.out, fields)
    seconds = time.perf_counter() - t0
    sizes = {k: v.shape for k, v in fields.items() if np.ndim(v) > 0}
    print(f"wrote {args.out}: {sizes}")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (numpy)")
    what = f"seed {args.seed}" if args.seed is not None else "abc"
    print(f"{what}: {seconds:.2f} s on {where}", flush=True)
    return fields


if __name__ == "__main__":
    main()
