"""The plain reference against the port's eager CPU step and decode, at
tiny widths, through the benchmark's own loops; and the reference's jet
against autograd's derivatives of its own query.

Tolerances: the port's CPU path runs in float32 and assembles its batch
in float32 on the device, the reference in float64 on the host, so the
inputs differ by ~5e-7. At these tiny widths (a leaf of a few dozen
values, 64 points a step) that rounding reaches far: over nine seeds
(my CPU runs) the first gradient's worst leaf read up to 7.1e-5, and
Adam, whose first updates are near +-lr for any gradient above its eps,
turned rounding-level gradients into parameter changes 4.7e-3 apart and
losses of the later steps 2.1e-4 apart (rb2d; turb3d 5.7e-5 and 6.4e-7);
the dispatch replayed after the window, followed from the program's own
state, read losses up to 3.2e-6 and changes up to 6.0e-4 apart over
three seeds (my CPU runs).
A planted fault reads 1e-1 or more (``test_bench_faults.py``). A decoded
window moves by under 2e-6."""

import numpy as np
import pytest
import torch

from stpde_bench.tests import tiny
from stpde_bench.reference import model as M


@pytest.mark.parametrize("workload", tiny.TRAIN)
def test_reference_follows_the_ports_steps(workload):
    result, numbers = tiny.run_cpu(tiny.tiny_cell(workload))
    assert numbers["loss_gap"] < 1e-3, numbers
    assert numbers["grad_gap"] < 3e-4, numbers
    assert numbers["change_gap"] < 2e-2, numbers
    assert numbers["replay_loss_gap"] < 1e-4, numbers
    assert numbers["replay_change_gap"] < 2e-2, numbers
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("workload", tiny.DECODE)
def test_reference_decodes_the_ports_windows(workload):
    result, numbers = tiny.run_cpu(tiny.tiny_cell(workload))
    assert numbers["rel_l2"] < 1e-5 and numbers["max_gap"] < 1e-4, numbers
    assert result["attempted"] >= 1


@pytest.mark.parametrize("dim", [3, 4])
def test_jet_is_the_querys_derivatives(dim):
    """Value, Jacobian and Hessian of ``query(jet=True)`` against
    autograd's derivatives of the plain query, in float64."""
    torch.manual_seed(dim)
    model = {"lat_dims": 5, "imnet_nf": 2, "out_channels": 3}
    params = {}
    for name, shape, init, fan in M.imnet_specs(model, dim):
        params[name] = (torch.randn(shape, dtype=torch.float64) / fan ** 0.5
                        if init == "lecun" else
                        0.1 * torch.randn(shape, dtype=torch.float64))
    grid = (3, 4, 3, 2)[:dim]
    latent = torch.randn(*grid, 5, dtype=torch.float64)
    pts = torch.rand(6, dim, dtype=torch.float64) * 0.9 + 0.05
    value, jac, hess = M.query(params, latent, pts, 0.01, jet=True)
    for i in range(pts.shape[0]):
        f = lambda p: M.query(params, latent, p[None], 0.01)[0]
        j = torch.autograd.functional.jacobian(f, pts[i])
        h = torch.stack([torch.autograd.functional.hessian(
            lambda p: f(p)[o], pts[i]) for o in range(3)])
        np.testing.assert_allclose(value[i], f(pts[i]), rtol=1e-12)
        np.testing.assert_allclose(jac[i], j, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(hess[i], h, rtol=1e-9, atol=1e-12)
