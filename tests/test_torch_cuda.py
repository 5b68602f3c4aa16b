"""On-card checks of the CUDA kernels (decode and jet) against their
plain twins.

Marked ``cuda``: without a card every test skips (a CUDA kernel has no
CPU mode). On a machine with one, from the repo root:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures jax, which that
machine does not have; this file imports only torch and the port.)

Tolerance rtol = atol = 1e-4: f32 operands and accumulation on both
sides; the kernel sums in another order than cuBLAS and blends before
the head in its own order.
"""

import copy

import numpy as np
import pytest
import torch

from space_time_pde_torch.models import ImNet
from space_time_pde_torch.models.nonlinearities import NONLINEARITIES
from space_time_pde_torch.ops import _build
from space_time_pde_torch.ops import fused_query as fq

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, nf, c, dim, n, activation, seed=0):
    torch.manual_seed(seed)
    imnet = ImNet(dim=dim, in_features=c, out_features=4, nf=nf,
                  activation=activation).to(device)
    rng = np.random.RandomState(seed)
    spatial = (5, 6, 7, 4)[:dim]
    grid = torch.from_numpy(rng.randn(*spatial, c).astype(np.float32))
    table = fq.cell_major_features(grid).contiguous().to(device)
    n_cells = table.shape[0]
    cell_flat = torch.from_numpy(
        rng.randint(0, n_cells, n).astype(np.int32)).to(device)
    frac = rng.rand(n, dim).astype(np.float32)
    frac[: min(n, 4)] = np.array([0.0, 1.0, 0.5, 1.0])[: min(n, 4), None]
    frac = torch.from_numpy(frac).to(device)
    with torch.no_grad():
        packed = fq.pack_imnet_params(imnet)
    return packed, table, cell_flat, frac


def test_kernels_build(device):
    _build.load()
    log = _build.build_log()
    print(f"nvcc {log.get('seconds', 0.0):.1f}s")
    for src in ("fused_query", "fused_jet"):
        print(f"{src}.cu:\n{log.get(src, '')}")


CASES = ([(4, 8, 3, 257, a) for a in NONLINEARITIES]
         + [(8, 8, 2, 100, "leaky_relu"), (2, 4, 4, 33, "elu"),
            (64, 64, 3, 4096, "leaky_relu"), (64, 64, 3, 4096, "gelu")])


@pytest.mark.parametrize("nf,c,dim,n,activation", CASES)
def test_kernels_match_plain(device, nf, c, dim, n, activation):
    packed, table, cell_flat, frac = _inputs(device, nf, c, dim, n,
                                             activation)
    kw = dict(nf=nf, activation=activation, negative_slope=0.01)
    want = fq.decode_blend_gather_plain(table, cell_flat, frac, packed, **kw)
    fq.reset_launches()
    got = fq.decode_blend_gather(table, cell_flat, frac, packed, **kw)
    feats2 = table[cell_flat.long()].reshape(-1, c).contiguous()
    got2 = fq.decode_blend(feats2, frac, packed, n_corners=2 ** dim, **kw)
    torch.cuda.synchronize()
    assert fq.LAUNCHES == {"decode_blend_gather": 1, "decode_blend": 1}
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    np.testing.assert_allclose(got2.cpu().numpy(), want.cpu().numpy(), **TOL)


def test_out_of_range_cell_decodes_nan(device):
    packed, table, cell_flat, frac = _inputs(device, 4, 8, 3, 16,
                                             "leaky_relu")
    cell_flat[3] = table.shape[0]
    got = fq.decode_blend_gather(table, cell_flat, frac, packed, nf=4)
    torch.cuda.synchronize()
    bad = torch.isnan(got).any(dim=1).cpu().numpy()
    assert bad[3] and bad.sum() == 1


def test_shared_memory_overflow_raises(device):
    """The kernel sizes its shared memory; nf = 128 needs ~390 KB a
    block, more than the card has, and the launch's error is raised."""
    packed, table, cell_flat, frac = _inputs(device, 128, 8, 3, 16,
                                             "leaky_relu")
    assert fq.block_points(3, device) == _build.load().stpde_block_rows() // 8
    with pytest.raises(RuntimeError, match="CUDA error"):
        fq.decode_blend_gather(table, cell_flat, frac, packed, nf=128)


# --- jet kernels (csrc/fused_jet.cu) ----------------------------------------
#
# Against the plain twin run in float64 on the card: per quantity, the
# kernel may sit at most twice as far from it as the f32 twin does,
# |err| <= 1e-4 |ref| + atol max|ref| (a LeakyReLU mask that flips within
# f32 rounding moves a point's Jacobian and Hessian by a finite step, so
# the f32 floor is scale-relative), never below 1e-6 of max|ref|.


def _atol_needed(got, want):
    got, want = got.detach().double(), want.detach().double()
    scale = float(want.abs().max())
    if scale == 0.0:
        return 0.0
    return max(0.0, float((got - want).abs().sub(1e-4 * want.abs()).max())
               / scale)


def _held(got, plain32, plain64, what):
    need, floor = _atol_needed(got, plain64), _atol_needed(plain32, plain64)
    assert torch.isfinite(got).all(), what
    assert need <= max(2 * floor, 1e-6), (what, need, floor)


def _jet_inputs(device, nf, c, n, activation, seed=0):
    from space_time_pde_torch.ops import fused_jet as fj

    torch.manual_seed(seed)
    imnet = ImNet(dim=3, in_features=c, out_features=4, nf=nf,
                  activation=activation).to(device)
    with torch.no_grad():
        packed = fq.pack_imnet_params(imnet)
    rng = np.random.RandomState(seed)
    feats2 = torch.from_numpy(rng.randn(n * 8, c).astype(np.float32))
    frac = rng.rand(n, 3).astype(np.float32)
    frac[: min(n, 4)] = np.array([[0, 0, 0], [1, 1, 1], [0, 1, 0.5],
                                  [0.5, 0.5, 0.5]])[: min(n, 4)]
    ybar = torch.from_numpy(rng.randn(n, 10, 4).astype(np.float32))
    slope = fj.jet_slope(activation, 0.01)
    return (packed, feats2.to(device), torch.from_numpy(frac).to(device),
            ybar.to(device), slope)


JET_CASES = [(2, 4, 37, "leaky_relu"), (4, 8, 300, "relu"),
             (8, 16, 1000, "leaky_relu"), (64, 64, 2048, "leaky_relu")]


@pytest.mark.parametrize("nf,c,n,activation", JET_CASES)
def test_jet_kernels_match_plain(device, nf, c, n, activation):
    from space_time_pde_torch.ops import fused_jet as fj

    packed, feats2, frac, ybar, slope = _jet_inputs(device, nf, c, n,
                                                    activation)
    p64 = {k: v.double() for k, v in packed.items()}
    fj.reset_launches()
    out, ws = fj.jet_fwd(feats2, frac, packed, nf=nf, slope=slope)
    dfeats, grads = fj.jet_bwd(feats2, frac, packed, ws, ybar, nf=nf,
                               slope=slope)
    torch.cuda.synchronize()
    assert fj.LAUNCHES == {"jet_fwd": 1, "jet_bwd": 1}
    want = fj.jet_fwd_plain(feats2, frac, packed, nf=nf, slope=slope)
    want64 = fj.jet_fwd_plain(feats2.double(), frac.double(), p64, nf=nf,
                              slope=slope)
    for blk in range(out.shape[1]):
        _held(out[:, blk], want[:, blk], want64[:, blk], f"block {blk}")
    d32, g32 = fj.jet_bwd_plain(feats2, frac, packed, ybar, nf=nf,
                                slope=slope)
    d64, g64 = fj.jet_bwd_plain(feats2.double(), frac.double(), p64,
                                ybar.double(), nf=nf, slope=slope)
    _held(dfeats, d32, d64, "dfeats2")
    for name in grads:
        _held(grads[name], g32[name], g64[name], name)


def test_jet_backward_is_deterministic(device):
    """Parameter gradients are per-block partials summed in a fixed
    order: two runs agree bit for bit."""
    from space_time_pde_torch.ops import fused_jet as fj

    packed, feats2, frac, ybar, slope = _jet_inputs(device, 8, 16, 3000,
                                                    "leaky_relu")
    _, ws = fj.jet_fwd(feats2, frac, packed, nf=8)
    first = fj.jet_bwd(feats2, frac, packed, ws, ybar, nf=8)
    second = fj.jet_bwd(feats2, frac, packed, ws, ybar, nf=8)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    for name in first[1]:
        assert torch.equal(first[1][name], second[1][name]), name


def test_fused_query_jet_trains_through_kernels(device):
    """The autograd Function on the card (forward and backward kernels)
    against the same Function on the CPU (its plain twins)."""
    from space_time_pde_torch.ops import fused_jet as fj

    torch.manual_seed(3)
    imnet = ImNet(dim=3, in_features=8, out_features=4, nf=4)
    rng = np.random.RandomState(3)
    latent = torch.from_numpy(rng.randn(2, 4, 5, 6, 8).astype(np.float32))
    pts = torch.from_numpy(rng.rand(2, 50, 3).astype(np.float32))
    cot = [torch.from_numpy(rng.randn(2, 50, 4, *([3] * i)).astype(
        np.float32)) for i in range(3)]

    def grads(dev):
        model = copy.deepcopy(imnet).to(dev)
        lat = latent.to(dev).requires_grad_(True)
        outs = fj.fused_query_jet(model, lat, pts.to(dev))
        sum((o * c.to(dev)).sum() for o, c in zip(outs, cot)).backward()
        return [lat.grad.cpu()] + [p.grad.cpu() for p in model.parameters()]

    fj.reset_launches()
    got = grads(device)
    assert fj.LAUNCHES == {"jet_fwd": 1, "jet_bwd": 1}
    for g, w in zip(got, grads(torch.device("cpu"))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=3e-4,
                                   atol=3e-4 * float(w.abs().max()))


def test_jet_kernels_take_d3_only(device):
    from space_time_pde_torch.ops import fused_jet as fj

    imnet = ImNet(dim=4, in_features=4, out_features=2, nf=2).to(device)
    with pytest.raises(NotImplementedError, match="turb3d"):
        fj.fused_query_jet(imnet, torch.zeros(1, 3, 3, 3, 3, 4,
                                              device=device),
                           torch.zeros(1, 5, 4, device=device))
