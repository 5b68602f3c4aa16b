from space_time_pde_torch.train.optim import (
    COUNTERS, Optimizer, global_norm, make_optimizer)
from space_time_pde_torch.train.recovery import CliffDetector
from space_time_pde_torch.train.trainer import (
    REPLAYED, CapturedStep, TrainState, build_models, flax_init_, init_state,
    jet_compute_dtype, make_eval_fn, make_loss_fn, make_multi_step,
    make_train_step, reset_replayed)

__all__ = ["COUNTERS", "Optimizer", "global_norm", "make_optimizer",
           "CliffDetector", "CapturedStep", "TrainState", "build_models",
           "flax_init_", "init_state", "jet_compute_dtype", "make_eval_fn",
           "make_loss_fn", "make_multi_step", "make_train_step",
           "REPLAYED", "reset_replayed"]
