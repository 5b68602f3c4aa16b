from space_time_pde_torch.models.imnet import ImNet
from space_time_pde_torch.models.local_implicit_grid import (
    query_local_implicit_grid,
)
from space_time_pde_torch.models.unet3d import ResBlock3D, UNet3d

__all__ = ["ImNet", "UNet3d", "ResBlock3D", "query_local_implicit_grid"]
