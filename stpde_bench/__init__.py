"""The benchmark of ``space_time_pde_torch`` on one NVIDIA H100: the
rb2d and turb3d flagship recipes trained and densely decoded, driven by
``BENCHMARK.json`` (``run.py``)."""
