from space_time_pde_torch.physics.pde import PDELayer
from space_time_pde_torch.physics.rb2 import RB2_EQUATIONS, get_rb2_pde_layer
from space_time_pde_torch.physics.systems import (
    available_systems, get_pde_layer, register_system)

__all__ = ["PDELayer", "RB2_EQUATIONS", "get_rb2_pde_layer",
           "get_pde_layer", "available_systems", "register_system"]
