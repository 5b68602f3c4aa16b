"""The control comes out not correct: the reference put in the
program's place and computed one precision below the configuration's
(TF32 for f32), at each cell's own size, on three seeds, fails at least
one of the cell's limits. Needs a card (TF32 exists only there); run as

    python -m pytest -p no:cacheprovider -m cuda stpde_bench/tests
"""

import pytest
import torch

from stpde_bench import calibrate
from stpde_bench.harness import spec
from stpde_bench.reference import compare

WORKLOADS = ("rb2d-train-f32", "turb3d-train-f32", "rb2d-decode-f32",
             "turb3d-decode-f32")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 runs only on a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_limits(card, workload):
    cell = spec.resolve(workload)
    for seed in (2 ** 31 + 301, 302, 303):
        numbers = calibrate.control(cell, seed, card)
        assert not compare.verdict(numbers, cell.limits), (seed, numbers)
