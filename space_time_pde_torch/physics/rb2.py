"""Rayleigh–Bénard 2-D Boussinesq equations for the PDE layer (PyTorch).

Counterpart of ``space_time_pde_tpu/physics/rb2.py`` (equation strings
only, identical): builds a
:class:`~space_time_pde_torch.physics.pde.PDELayer` with the four
Boussinesq equations in the Dedalus non-dimensional form used by the
paper (arXiv:2005.01463), with

    P = (Rayleigh * Prandtl) ** (-1/2)
    R = (Rayleigh / Prandtl) ** (-1/2)

Fields: p (pressure), b (buoyancy/temperature), u (x-velocity),
w (z-velocity); coordinates (t, z, x).

The reference rescales the symbolic equations for the channel-normalized
fields and crop-normalized coordinates by folding mean/std and crop
extents in as constant factors; here that is declared once through
``PDELayer.set_scaling`` and the equations stay in physical form.
"""

from __future__ import annotations

from typing import Optional, Sequence

from space_time_pde_torch.physics.pde import PDELayer

__all__ = ["get_rb2_pde_layer", "RB2_EQUATIONS"]

# Boussinesq RB convection (Dedalus form; reference train.py registers
# these same four equations in the dif DSL).
RB2_EQUATIONS = (
    ("continuity",
     "dif(u, x) + dif(w, z) = 0"),
    ("temperature",
     "dif(b, t) - P_*(dif(dif(b, x), x) + dif(dif(b, z), z))"
     " = -(u*dif(b, x) + w*dif(b, z))"),
    ("momentum_x",
     "dif(u, t) - R_*(dif(dif(u, x), x) + dif(dif(u, z), z)) + dif(p, x)"
     " = -(u*dif(u, x) + w*dif(u, z))"),
    ("momentum_z",
     "dif(w, t) - R_*(dif(dif(w, x), x) + dif(dif(w, z), z)) + dif(p, z)"
     " - b = -(u*dif(w, x) + w*dif(w, z))"),
)


def get_rb2_pde_layer(
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
    t_crop: float = 1.0,
    z_crop: float = 1.0,
    x_crop: float = 1.0,
    prandtl: float = 1.0,
    rayleigh: float = 1e6,
    **_,
) -> PDELayer:
    """Build the RB2D physics layer.

    Args:
      mean, std: per-channel (p, b, u, w) normalization statistics of
        the fields the bound forward method emits (None = unnormalized).
      t_crop, z_crop, x_crop: PHYSICAL extents of the crop that the
        forward method's [0, 1]-normalized coordinates span.
      prandtl, rayleigh: dimensionless groups (paper: Pr=1, Ra=1e6).

    Returns a PDELayer with equations named continuity / temperature /
    momentum_x / momentum_z, expecting fwd: [..., (t,z,x)] -> [..., (p,b,u,w)].
    """
    p_const = (rayleigh * prandtl) ** (-0.5)
    r_const = (rayleigh / prandtl) ** (-0.5)

    layer = PDELayer(in_vars="t, z, x", out_vars="p, b, u, w")
    for name, eqn in RB2_EQUATIONS:
        eqn = eqn.replace("P_", repr(p_const)).replace("R_", repr(r_const))
        layer.add_equation(eqn, name=name)
    layer.set_scaling(
        coord_scales=(t_crop, z_crop, x_crop),
        out_means=mean,
        out_stds=std,
    )
    return layer
