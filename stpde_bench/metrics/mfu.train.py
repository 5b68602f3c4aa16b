"""The training step's model operations (``readers.train_step_flop``)
over the untraced window's wall time a step, as a share of the card's
f32-operand peak (TF32, 495 TFLOP/s)."""

from stpde_bench.harness import readers
from stpde_bench.harness.peaks import PEAKS


def read(run):
    rec = run.rec
    if "steps" not in rec:
        return None
    per_step = rec["window_s"] / rec["steps"]
    return readers.train_step_flop(run.cell) / per_step / PEAKS["float32"] \
        * 100
