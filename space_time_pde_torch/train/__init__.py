from space_time_pde_torch.train.optim import (
    Optimizer, global_norm, make_optimizer)
from space_time_pde_torch.train.recovery import CliffDetector
from space_time_pde_torch.train.trainer import (
    TrainState, build_models, flax_init_, init_state, jet_compute_dtype,
    make_eval_fn, make_loss_fn, make_multi_step, make_train_step)

__all__ = ["Optimizer", "global_norm", "make_optimizer", "CliffDetector",
           "TrainState", "build_models", "flax_init_", "init_state",
           "jet_compute_dtype", "make_eval_fn", "make_loss_fn", "make_multi_step",
           "make_train_step"]
