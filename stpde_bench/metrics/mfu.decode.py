"""A window's operations (``readers.window_flop``: the encoder's forward
and the decode of every lattice point) over the untraced window's wall
time a window, as a share of the card's f32-operand peak (TF32,
495 TFLOP/s)."""

from stpde_bench.harness import readers
from stpde_bench.harness.peaks import PEAKS


def read(run):
    rec = run.rec
    if not rec.get("windows"):
        return None
    per_window = rec["window_s"] / rec["windows"]
    return readers.window_flop(run.cell) / per_window / PEAKS["float32"] \
        * 100
