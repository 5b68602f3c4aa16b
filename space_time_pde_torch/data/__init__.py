from space_time_pde_torch.data.dataset import RB2EvalData
from space_time_pde_torch.data.dataset4d import Field4DDataset
from space_time_pde_torch.data.generator import (
    abc_flow_fields, beltrami_fields, beltrami_realization_params, save_npz,
    simulate_rb2d, taylor_green_fields)

__all__ = ["RB2EvalData", "Field4DDataset", "simulate_rb2d",
           "taylor_green_fields",
           "abc_flow_fields", "beltrami_realization_params",
           "beltrami_fields", "save_npz"]
