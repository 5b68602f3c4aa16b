"""The recipe's training steps, written out.

A batch: ``B`` crops of the simulation field at random origins and ``N``
uniform points in each crop (``draw``: origins by ``randint`` along each
axis, the first through the table of valid start frames, then the
points by ``rand``, one call each from the run's ``RandomState``, as the
recipe's data pipeline draws them). The encoder reads each crop's low-res
lattice (``lres`` nodes an axis, endpoints on the crop's first and last
frame and cell), the points read the field's multilinear value, and both
are normalised by the field's channel statistics (``assemble``).

A step: encode, the decoder's jet at the points, the regression loss of
the value against the field, the PDE residual penalty from the jet,
``loss = reg + alpha * pde``, the gradient, then optax's
``chain(clip_by_global_norm, adam)`` with a cosine schedule read at the
count before the step (``steps``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from stpde_bench.reference import model as M
from stpde_bench.reference.physics import residual_loss

B1, B2, EPS = 0.9, 0.999, 1e-8


def draw(rng: np.random.RandomState, origin_counts, valid_t0, batch: int,
         n_pts: int):
    dim = len(origin_counts)
    origins = np.stack([rng.randint(origin_counts[i], size=batch)
                        for i in range(dim)], -1).astype(np.int64)
    origins[:, 0] = np.asarray(valid_t0)[origins[:, 0]]
    pts = rng.rand(batch, n_pts, dim).astype(np.float32)
    return origins, pts


def _read(field: np.ndarray, origins, crop, pts):
    """Multilinear values (float64) of ``field [*grid, C]`` at points
    ``[B, P, D]`` in crop coordinates of the crops at ``origins``."""
    dim = len(crop)
    crop = np.asarray(crop, np.float64)
    s = origins[:, None, :] + pts.astype(np.float64) * (crop - 1.0)
    grid = np.asarray(field.shape[:dim])
    s = np.clip(s, 0, grid - 1.0)
    cell = np.clip(np.floor(s).astype(np.int64), 0, grid - 2)
    frac = s - cell
    out = 0.0
    for k in range(2 ** dim):
        off = [(k >> (dim - 1 - a)) & 1 for a in range(dim)]
        w = np.ones(frac.shape[:-1])
        idx = []
        for a in range(dim):
            w = w * (frac[..., a] if off[a] else 1.0 - frac[..., a])
            idx.append(cell[..., a] + off[a])
        out = out + w[..., None] * field[tuple(idx)].astype(np.float64)
    return out


def assemble(field, origins, pts, crop, lres, mean, std):
    """The normalised batch: ``lres [B, *lres, C]``, ``point_coord``,
    ``point_value [B, N, C]`` (float32)."""
    b = origins.shape[0]
    axes = [np.linspace(0.0, 1.0, n) for n in lres]
    lattice = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(
        1, -1, len(lres))
    low = _read(field, origins, crop, np.broadcast_to(
        lattice, (b,) + lattice.shape[1:]))
    vals = _read(field, origins, crop, pts)
    norm = lambda x: ((x - mean) / std).astype(np.float32)
    return {"lres": norm(low).reshape(b, *lres, -1), "point_coord": pts,
            "point_value": norm(vals)}


def loss_fn(params: Dict[str, torch.Tensor], batch, cfg: dict,
            mean, std) -> torch.Tensor:
    m, tr, data = cfg["model"], cfg["train"], cfg["data"]
    pu, pi = M.split(params)
    latent = M.Encoder(pu, m, data["lres"])(batch["lres"])
    pred, jac, hess = [], [], []
    for grid, pts in zip(latent, batch["point_coord"]):
        v, j, h = M.query(pi, grid, pts, m["negative_slope"], jet=True)
        pred.append(v)
        jac.append(j)
        hess.append(h)
    pred, jac, hess = (torch.stack(t) for t in (pred, jac, hess))
    err = pred - batch["point_value"]
    kind = tr["reg_loss"]
    if kind == "l1":
        reg = torch.mean(torch.abs(err))
    elif kind == "l2":
        reg = torch.mean(err * err)
    else:
        a = torch.abs(err)
        q = torch.clamp(a, max=1.0)
        reg = torch.mean(0.5 * q * q + (a - q))
    extents = [(c - 1) * s for c, s in zip(data["crop"], data["spacing"])]
    pde = residual_loss(cfg["physics"], pred, jac, hess, mean, std, extents,
                        tr["pde_loss"])
    return reg + tr["alpha_pde"] * pde


def learning_rate(tr: dict, count: int) -> float:
    if tr["lr_schedule"] != "cosine":
        return tr["lr"]
    decay = tr["epochs"] * tr["steps_per_epoch"]
    c = min(count, decay)
    return tr["lr"] * 0.5 * (1 + math.cos(math.pi * c / decay))


def skip(rng: np.random.RandomState, origin_counts, valid_t0, batch: int,
         n_pts: int, n_batches: int) -> None:
    """Advance ``rng`` past ``n_batches`` draws."""
    for _ in range(n_batches):
        draw(rng, origin_counts, valid_t0, batch, n_pts)


def steps(params0: Dict[str, torch.Tensor], cfg: dict, field: np.ndarray,
          stats, batch_rng: np.random.RandomState, origin_counts, valid_t0,
          n_steps: int, device, dtype=torch.float32,
          start=None) -> Dict[str, object]:
    """``n_steps`` steps from ``params0`` on the next ``n_steps`` batches
    that ``batch_rng`` draws: each step's loss, the first step's gradient
    as the optimizer takes it (after the clip), and the parameters after
    the last step; all in ``dtype``. The optimizer starts from nothing,
    or from ``start``: ``{"mu", "nu", "count"}`` of a run in flight."""
    tr, data = cfg["train"], cfg["data"]
    mean, std = stats
    cast = lambda d: {k: v.detach().to(device=device, dtype=dtype).clone()
                      for k, v in d.items()}
    params = cast(params0)
    if start is None:
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        count0 = 0
    else:
        mu, nu, count0 = cast(start["mu"]), cast(start["nu"]), start["count"]
    losses: List[float] = []
    first = None
    for count in range(count0, count0 + n_steps):
        origins, pts = draw(batch_rng, origin_counts, valid_t0, tr["batch"],
                            data["points_per_crop"])
        host = assemble(field, origins, pts, data["crop"], data["lres"],
                        mean, std)
        batch = {k: torch.as_tensor(v, device=device).to(dtype) for k, v in
                 host.items()}
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(leaves, batch, cfg, mean, std)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                 for k, g in zip(leaves, grads)}
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            clip = tr["clip_grad"]
            if clip and float(norm) >= clip:
                grads = {k: g / norm * clip for k, g in grads.items()}
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            lr = learning_rate(tr, count)
            bc1 = 1 - B1 ** (count + 1)
            bc2 = 1 - B2 ** (count + 1)
            new = {}
            for k, g in grads.items():
                mu[k] = (1 - B1) * g + B1 * mu[k]
                nu[k] = (1 - B2) * g * g + B2 * nu[k]
                upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
                new[k] = params[k] - lr * upd
            params = new
    return {"loss": losses, "grad": first, "params": params}
