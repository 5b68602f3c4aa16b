"""PDE residuals of the two flagship systems, from a decoder's jet.

The decoder works in normalised units: each field is ``(phys - mean) /
std`` and each coordinate spans the crop as [0, 1], so a physical
derivative of field c by axes a (and b) is ``std_c * d / (L_a [L_b])``
with ``L`` the crop's physical extents.

- ``rb2d``: the Boussinesq equations of Rayleigh-Benard convection in
  the Dedalus form the paper trains with; fields (p, b, u, w) over
  (t, z, x); P = (Ra Pr)^-1/2, R = (Ra / Pr)^-1/2.
- ``ns3d``: incompressible Navier-Stokes; fields (p, u, v, w) over
  (t, z, y, x); viscosity nu.
"""

from __future__ import annotations

from typing import Dict

import torch


class Fields:
    """Physical values, first and second derivatives of each field."""

    def __init__(self, pred, jac, hess, names, axes, mean, std, extents):
        dev, dt = pred.device, pred.dtype
        std = torch.as_tensor(std, dtype=dt, device=dev)
        mean = torch.as_tensor(mean, dtype=dt, device=dev)
        ext = torch.as_tensor(extents, dtype=dt, device=dev)
        self.val = pred * std + mean
        self.d1 = jac * std[:, None] / ext
        self.d2 = hess * std[:, None, None] / (ext[:, None] * ext[None, :])
        self.c = {n: i for i, n in enumerate(names)}
        self.a = {n: i for i, n in enumerate(axes)}

    def __call__(self, f, *axes):
        c = self.c[f]
        if not axes:
            return self.val[..., c]
        if len(axes) == 1:
            return self.d1[..., c, self.a[axes[0]]]
        return self.d2[..., c, self.a[axes[0]], self.a[axes[1]]]


def rb2d(f: Fields, rayleigh: float, prandtl: float, **_):
    pc = (rayleigh * prandtl) ** -0.5
    rc = (rayleigh / prandtl) ** -0.5
    u, w, b = f("u"), f("w"), f("b")
    return {
        "continuity": f("u", "x") + f("w", "z"),
        "temperature": (f("b", "t") - pc * (f("b", "x", "x")
                                            + f("b", "z", "z"))
                        + u * f("b", "x") + w * f("b", "z")),
        "momentum_x": (f("u", "t") - rc * (f("u", "x", "x")
                                           + f("u", "z", "z"))
                       + f("p", "x") + u * f("u", "x") + w * f("u", "z")),
        "momentum_z": (f("w", "t") - rc * (f("w", "x", "x")
                                           + f("w", "z", "z"))
                       + f("p", "z") - b + u * f("w", "x")
                       + w * f("w", "z")),
    }


def ns3d(f: Fields, viscosity: float, **_):
    u, v, w = f("u"), f("v"), f("w")
    out = {"continuity": f("u", "x") + f("v", "y") + f("w", "z")}
    for comp, name, ax in (("u", "momentum_x", "x"), ("v", "momentum_y", "y"),
                           ("w", "momentum_z", "z")):
        lap = sum(f(comp, a, a) for a in ("x", "y", "z"))
        out[name] = (f(comp, "t") + u * f(comp, "x") + v * f(comp, "y")
                     + w * f(comp, "z") + f("p", ax) - viscosity * lap)
    return out


SYSTEMS = {
    "rb2d": (rb2d, ("p", "b", "u", "w"), ("t", "z", "x")),
    "ns3d": (ns3d, ("p", "u", "v", "w"), ("t", "z", "y", "x")),
}


def huber(r: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    a = torch.abs(r)
    return torch.mean(torch.where(a <= delta, 0.5 * r * r,
                                  delta * (a - 0.5 * delta)))


def residual_loss(physics: dict, pred, jac, hess, mean, std, extents,
                  kind: str) -> torch.Tensor:
    """The sum over the system's equations of each residual's mean
    penalty (``huber``, delta 1, or ``l2``)."""
    fn, names, axes = SYSTEMS[physics["system"]]
    res: Dict[str, torch.Tensor] = fn(
        Fields(pred, jac, hess, names, axes, mean, std, extents), **physics)
    pen = huber if kind == "huber" else (lambda r: torch.mean(r * r))
    return sum(pen(r) for r in res.values())
