"""space_time_pde_torch — the PyTorch / CUDA port of space_time_pde_tpu.

MeshfreeFlowNet-style space-time super-resolution (UNet3d encoder ->
latent grid -> ImNet local-implicit-grid decoder) on an NVIDIA H100.
The JAX package beside it is the reference; module names mirror it so
each counterpart is easy to find. This package imports torch and never
jax. Slice 1 covers the rb2d eval path:

  data/       eval windows (numpy/scipy), Taylor–Green fixture, splits
  models/     nonlinearities, ImNet, UNet3d, local-implicit-grid oracle
  ops/        grid interpolation, fused decode (CUDA kernels + plain
              PyTorch twins), nvcc/ctypes build
  csrc/       the CUDA C++ kernel sources (sm_90a)
  bridge.py   flax params (numpy) -> state_dicts; exported-npz I/O
  inference.py  dense-lattice decode, stitching
  utils/      config
"""

__version__ = "0.1.0"
