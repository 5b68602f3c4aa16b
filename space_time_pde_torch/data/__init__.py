from space_time_pde_torch.data.dataset import RB2EvalData
from space_time_pde_torch.data.generator import save_npz, taylor_green_fields

__all__ = ["RB2EvalData", "taylor_green_fields", "save_npz"]
