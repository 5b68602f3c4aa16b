"""The benchmark's operation and byte counts tied to the arithmetic they
were copied from (``chip_smoke.py::bound``, where a 3xTF32 kernel's
operations are three TF32 products each), and the encoder's counts to the
reference's own convolutions."""

import math

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from stpde_bench.counts import encoder, kernels
from stpde_bench.harness import spec
from stpde_bench.reference import model as M

# (kind, n) at the flagship shapes: 65,536 decode points a chunk, the
# step's 8,192 (rb2d) and 4,096 (turb3d) jet points.
SHAPES = [("decode_blend_gather", 3, 65536), ("decode_blend_gather", 4, 32768),
          ("jet_fwd", 3, 8192), ("jet_bwd", 3, 8192),
          ("jet_fwd", 4, 4096), ("jet_bwd", 4, 4096)]


@pytest.mark.parametrize("kind,dim,n", SHAPES)
def test_counts_are_bounds_over_three(kind, dim, n):
    c, nf, out, n_cells = 64, 64, 4, 2835
    t_ms, by = chip_smoke.bound(kind, n=n, c=c, dim=dim, nf=nf, out=out,
                                n_cells=n_cells, math="tf32x3")
    fn = getattr(kernels, kind)
    kw = dict(n_cells=n_cells) if kind.startswith("decode") else {}
    flop, byts = fn(n, c, dim, nf, out, **kw)
    assert by == "operations"
    assert math.isclose(t_ms, 3 * flop / chip_smoke.TF32_FLOPS * 1e3,
                        rel_tol=1e-12)
    t_bytes = chip_smoke.bound(kind, n=n, c=c, dim=dim, nf=nf, out=out,
                               n_cells=n_cells, math="ffma")
    assert byts / chip_smoke.HBM_BYTES * 1e3 <= t_bytes[0]


@pytest.mark.parametrize("workload", ["rb2d-train-f32", "turb3d-train-f32"])
def test_encoder_counts_are_the_references_convolutions(workload):
    """The walk of ``counts/encoder.py`` against the multiply-adds of the
    convolutions the reference encoder runs (one window, small widths)."""
    cfg = spec.resolve(workload).config
    model = dict(cfg["model"], unet_nf=4, unet_mf=16, lat_dims=6)
    grid = cfg["data"]["lres"]
    params = {n[5:]: torch.zeros(s) for n, s, _, _ in
              M.param_specs(model, grid) if n.startswith("unet.")}
    seen = []
    wrapped = {}
    for name in ("conv3d", "conv1d", "conv_transpose3d"):
        orig = getattr(F, name)

        def counting(x, w, *a, _orig=orig, _name=name, **k):
            y = _orig(x, w, *a, **k)
            if _name == "conv_transpose3d":
                seen.append(y[0, 0].numel() * y.shape[0] * w.shape[0]
                            * w.shape[1])
            else:
                seen.append(y.numel() * w[0].numel())
            return y
        wrapped[name] = orig
        setattr(F, name, counting)
    try:
        x = torch.zeros(1, *grid, model["in_channels"])
        M.Encoder(params, model, grid)(x)
    finally:
        for name, orig in wrapped.items():
            setattr(F, name, orig)
    assert sum(seen) == sum(encoder.conv_macs(model, grid))
