"""space_time_pde_torch — the PyTorch / CUDA port of space_time_pde_tpu.

MeshfreeFlowNet-style space-time super-resolution (UNet3d encoder ->
latent grid -> ImNet local-implicit-grid decoder) on an NVIDIA H100.
The JAX package beside it is the reference; module names mirror it so
each counterpart is easy to find. This package imports torch and never
jax. Slice 1 covers the rb2d eval path, slice 2 its training step:

  data/       eval windows + training crops (numpy/scipy copies),
              DeviceSampler, prefetcher, Taylor–Green fixture, splits
  models/     nonlinearities, ImNet, UNet3d, local-implicit-grid oracle
  ops/        grid interpolation, analytic jet, fused decode and fused
              jet (CUDA kernels + plain PyTorch twins), nvcc/ctypes build
  csrc/       the CUDA C++ kernel sources (sm_90a)
  physics/    the sympy ``dif`` DSL lowered to torch; RB2 and other systems
  train/      models, init, loss, steps, optimizer, cliff detector
  bridge.py   flax params (numpy) -> state_dicts; exported-npz I/O
  inference.py  dense-lattice decode, stitching
  utils/      config, checkpoints, metrics log
"""

__version__ = "0.1.0"
