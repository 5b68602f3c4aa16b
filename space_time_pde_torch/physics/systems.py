"""Pluggable PDE systems beyond Rayleigh–Bénard (PyTorch).

Counterpart of ``space_time_pde_tpu/physics/systems.py``: the same
registry and the same equation strings.

The reference hard-codes only the RB2D Boussinesq equations (registered
in its ``train.py``); the PDE layer itself is system-agnostic. This
module makes that pluggability first-class (BASELINE.json config #4:
"swapped PDE system (incompressible NS / advection–diffusion via sympy
spec)"), with a registry keyed by name so drivers can select
``--pde_system``.

Every factory returns a configured
:class:`~space_time_pde_torch.physics.pde.PDELayer` expecting
``fwd: [..., (t, z, x)] -> [..., out_vars]`` in [0,1]-normalized crop
coordinates, with physical scaling declared via ``set_scaling``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

from space_time_pde_torch.physics.pde import PDELayer
from space_time_pde_torch.physics.rb2 import get_rb2_pde_layer

__all__ = ["get_pde_layer", "register_system", "available_systems",
           "get_ns2d_pde_layer", "get_ns3d_pde_layer",
           "get_advection_diffusion_pde_layer"]


def get_ns2d_pde_layer(
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
    t_crop: float = 1.0,
    z_crop: float = 1.0,
    x_crop: float = 1.0,
    viscosity: float = 1e-3,
    **_,
) -> PDELayer:
    """Incompressible 2-D Navier–Stokes (p, u, w) + passive channel b.

    Fields keep the RB2D 4-channel layout (b is advected passively with
    the same diffusivity as momentum) so datasets/models are reusable.
    """
    nu = repr(float(viscosity))
    layer = PDELayer(in_vars="t, z, x", out_vars="p, b, u, w")
    layer.add_equation("dif(u, x) + dif(w, z) = 0", name="continuity")
    layer.add_equation(
        f"dif(u, t) + u*dif(u, x) + w*dif(u, z) + dif(p, x)"
        f" - {nu}*(dif(dif(u, x), x) + dif(dif(u, z), z)) = 0",
        name="momentum_x")
    layer.add_equation(
        f"dif(w, t) + u*dif(w, x) + w*dif(w, z) + dif(p, z)"
        f" - {nu}*(dif(dif(w, x), x) + dif(dif(w, z), z)) = 0",
        name="momentum_z")
    layer.add_equation(
        f"dif(b, t) + u*dif(b, x) + w*dif(b, z)"
        f" - {nu}*(dif(dif(b, x), x) + dif(dif(b, z), z)) = 0",
        name="scalar")
    layer.set_scaling(coord_scales=(t_crop, z_crop, x_crop),
                      out_means=mean, out_stds=std)
    return layer


def get_advection_diffusion_pde_layer(
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
    t_crop: float = 1.0,
    z_crop: float = 1.0,
    x_crop: float = 1.0,
    diffusivity: float = 1e-3,
    velocity: Sequence[float] = (1.0, 0.0),   # (cx, cz)
    **_,
) -> PDELayer:
    """Linear advection–diffusion of scalar b with constant velocity.

    Only the b channel carries physics; p/u/w are unconstrained (their
    equations are omitted, mirroring how the reference ablates
    equations via alpha_pde=0).
    """
    kappa = repr(float(diffusivity))
    cx, cz = (repr(float(v)) for v in velocity)
    layer = PDELayer(in_vars="t, z, x", out_vars="p, b, u, w")
    layer.add_equation(
        f"dif(b, t) + {cx}*dif(b, x) + {cz}*dif(b, z)"
        f" - {kappa}*(dif(dif(b, x), x) + dif(dif(b, z), z)) = 0",
        name="advection_diffusion")
    layer.set_scaling(coord_scales=(t_crop, z_crop, x_crop),
                      out_means=mean, out_stds=std)
    return layer


def get_ns3d_pde_layer(
    mean: Optional[Sequence[float]] = None,
    std: Optional[Sequence[float]] = None,
    t_crop: float = 1.0,
    z_crop: float = 1.0,
    y_crop: float = 1.0,
    x_crop: float = 1.0,
    viscosity: float = 1e-3,
    **_,
) -> PDELayer:
    """Incompressible 3-D Navier–Stokes (p, u, v, w) over (t, z, y, x).

    The 3-D-turbulence system for 4-D space-time context grids
    (BASELINE.json config #5); pairs with models.UNet4d and the N-d
    query path (2^4 corners).
    """
    nu = repr(float(viscosity))
    layer = PDELayer(in_vars="t, z, y, x", out_vars="p, u, v, w")
    layer.add_equation("dif(u, x) + dif(v, y) + dif(w, z) = 0",
                       name="continuity")
    for comp, name in (("u", "momentum_x"), ("v", "momentum_y"),
                       ("w", "momentum_z")):
        grad_p = {"momentum_x": "dif(p, x)", "momentum_y": "dif(p, y)",
                  "momentum_z": "dif(p, z)"}[name]
        layer.add_equation(
            f"dif({comp}, t) + u*dif({comp}, x) + v*dif({comp}, y)"
            f" + w*dif({comp}, z) + {grad_p}"
            f" - {nu}*(dif(dif({comp}, x), x) + dif(dif({comp}, y), y)"
            f" + dif(dif({comp}, z), z)) = 0",
            name=name)
    layer.set_scaling(coord_scales=(t_crop, z_crop, y_crop, x_crop),
                      out_means=mean, out_stds=std)
    return layer


_REGISTRY: Dict[str, Callable[..., PDELayer]] = {
    "rb2d": get_rb2_pde_layer,
    "ns2d": get_ns2d_pde_layer,
    "ns3d": get_ns3d_pde_layer,
    "advection_diffusion": get_advection_diffusion_pde_layer,
}


def register_system(name: str, factory: Callable[..., PDELayer]) -> None:
    """Register a custom PDE system factory under ``name``."""
    _REGISTRY[name] = factory


def available_systems() -> list:
    return sorted(_REGISTRY)


def get_pde_layer(system: str, **kwargs) -> PDELayer:
    """Build a PDE layer by registry name (``--pde_system`` flag)."""
    if system not in _REGISTRY:
        raise KeyError(
            f"unknown PDE system {system!r}; available: "
            f"{available_systems()}")
    return _REGISTRY[system](**kwargs)
