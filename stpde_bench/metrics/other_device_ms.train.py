"""Device milliseconds a training step in kernels that do not come from
the program's ``csrc/`` (PyTorch's own: the encoder's convolutions and
norms, the PDE layer, the loss, the optimizer, elementwise), from the
trace."""

from stpde_bench.harness import kernels


def read(run):
    tr = run.trace
    if tr is None or "traced_steps" not in run.rec:
        return None
    s = tr.seconds_by(lambda n: None if kernels.is_csrc(n) else "torch")
    return s.get("torch", 0.0) / run.rec["traced_steps"] * 1e3
