"""On-card checks of the CUDA kernels (decode and jet) against their
plain twins.

Marked ``cuda``: without a card every test skips (a CUDA kernel has no
CPU mode). On a machine with one, from the repo root:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures jax, which that
machine does not have; this file imports only torch and the port.)

Decode tolerance rtol = atol = 1e-4 against the f32 twin: the kernel
runs its products in 3xTF32 (f32-grade operands, f32 accumulation), sums
in another order than cuBLAS and blends before the head in its own
order. At the flagship widths it is also held to the plain twin run in
float64: at most twice as far from it as the f32 twin,
``|err| <= 1e-4 |ref| + atol max|ref|``.
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


# A block is 64 corner rows: 8 points at D = 3, 4 at D = 4. The edge cases
# take n = 1, one short of a block, one past it and a multiple of it.
EDGES = [(p, dim) for dim, b in ((3, 8), (4, 4))
         for p in (1, b - 1, b + 1, 4 * b)]
CASES = ([(4, 8, 3, 257, a) for a in NONLINEARITIES]
         + [(8, 8, 2, 100, "leaky_relu"), (2, 4, 4, 33, "elu"),
            (64, 64, 3, 4096, "leaky_relu"), (64, 64, 3, 4096, "gelu"),
            (64, 64, 4, 4096, "leaky_relu")]
         + [(8, 16, dim, n, "leaky_relu") for n, dim in EDGES]
         + [(64, 64, dim, n, "leaky_relu") for n, dim in EDGES])


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
    assert fq.LAUNCHES == {"decode_blend_gather": 1, "decode_blend": 1,
                           "decode_blend_gather_bf16": 0}
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    np.testing.assert_allclose(got2.cpu().numpy(), want.cpu().numpy(), **TOL)


# The bf16 instantiation against its bf16 twin: both round at the same
# points, but a sum taken in another order can land a bf16 value on the
# other side of a step, so the rule is four bf16 steps of max |twin|.
BF16_DIRECT = 4 * 2.0 ** -8


@pytest.mark.parametrize("nf,c,dim,n,activation", CASES)
def test_bf16_kernel_matches_plain(device, nf, c, dim, n, activation):
    packed, table, cell_flat, frac = _inputs(device, nf, c, dim, n,
                                             activation)
    table = table.to(torch.bfloat16)
    kw = dict(nf=nf, activation=activation, negative_slope=0.01,
              compute_dtype=torch.bfloat16)
    want = fq.decode_blend_gather_plain(table, cell_flat, frac, packed, **kw)
    fq.reset_launches()
    got = fq.decode_blend_gather(table, cell_flat, frac, packed, **kw)
    torch.cuda.synchronize()
    assert fq.LAUNCHES == {"decode_blend_gather": 0, "decode_blend": 0,
                           "decode_blend_gather_bf16": 1}
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= BF16_DIRECT * float(want.abs().max()), err


@pytest.mark.parametrize("dim", [3, 4])
def test_bf16_kernel_within_twice_twin_of_float64(device, dim):
    """At the flagship widths the bf16 kernel sits at most twice as far
    from the float64 f32-function as its bf16 twin does."""
    packed, table, cell_flat, frac = _inputs(device, 64, 64, dim, 4096,
                                             "leaky_relu")
    p64 = {k: v.double() for k, v in packed.items()}
    want64 = fq.decode_blend_gather_plain(table.double(), cell_flat,
                                          frac.double(), p64, nf=64)
    tb = table.to(torch.bfloat16)
    kw = dict(nf=64, compute_dtype=torch.bfloat16)
    got = fq.decode_blend_gather(tb, cell_flat, frac, packed, **kw)
    twin = fq.decode_blend_gather_plain(tb, cell_flat, frac, packed, **kw)
    torch.cuda.synchronize()
    need, floor = _atol_needed(got, want64), _atol_needed(twin, want64)
    assert bool(torch.isfinite(got).all()) and need <= 2 * floor, \
        (need, floor)


def test_out_of_range_cell_decodes_nan(device):
    packed, table, cell_flat, frac = _inputs(device, 4, 8, 3, 16,
                                             "leaky_relu")
    cell_flat[3] = table.shape[0]
    for tab, dt in ((table, torch.float32),
                    (table.to(torch.bfloat16), torch.bfloat16)):
        got = fq.decode_blend_gather(tab, cell_flat, frac, packed, nf=4,
                                     compute_dtype=dt)
        torch.cuda.synchronize()
        bad = torch.isnan(got).any(dim=1).cpu().numpy()
        assert bad[3] and bad.sum() == 1, dt


@pytest.mark.parametrize("dim", [3, 4])
def test_kernels_within_twice_f32_twin_of_float64(device, dim):
    """The 3xTF32 products at the flagship widths: the kernel sits at most
    twice as far from the float64 twin as the f32 twin does."""
    packed, table, cell_flat, frac = _inputs(device, 64, 64, dim, 4096,
                                             "leaky_relu")
    p64 = {k: v.double() for k, v in packed.items()}
    got = fq.decode_blend_gather(table, cell_flat, frac, packed, nf=64)
    want32 = fq.decode_blend_gather_plain(table, cell_flat, frac, packed,
                                          nf=64)
    want64 = fq.decode_blend_gather_plain(table.double(), cell_flat,
                                          frac.double(), p64, nf=64)
    torch.cuda.synchronize()
    need, floor = _atol_needed(got, want64), _atol_needed(want32, want64)
    assert bool(torch.isfinite(got).all()) and need <= 2 * floor, \
        (need, floor)


def test_shared_memory_overflow_raises(device):
    """The kernel sizes its shared memory from nf and C (227 KiB a block
    at most). At C = 8, nf = 64 fits (layer 1's 512 columns; 205 KiB) and
    nf = 65, whose widths pad to 576 columns, needs 237 KiB; at nf = 64,
    C = 96 fits (221 KiB) and C = 97 (latent rows padded to 128) needs
    229 KiB. The
    refused launch's CUDA error is raised, and the next launch runs."""
    assert fq.block_points(3, device) == _build.load().stpde_block_rows() // 8
    assert fq.block_points(4, device) == 4
    for nf, c, fits in ((64, 8, True), (65, 8, False), (64, 96, True),
                        (64, 97, False)):
        packed, table, cell_flat, frac = _inputs(device, nf, c, 3, 16,
                                                 "leaky_relu")
        if fits:
            got = fq.decode_blend_gather(table, cell_flat, frac, packed,
                                         nf=nf)
            want = fq.decode_blend_gather_plain(table, cell_flat, frac,
                                                packed, nf=nf)
            torch.cuda.synchronize()
            np.testing.assert_allclose(got.cpu().numpy(),
                                       want.cpu().numpy(), **TOL)
        else:
            with pytest.raises(RuntimeError, match="CUDA error"):
                fq.decode_blend_gather(table, cell_flat, frac, packed, nf=nf)


# --- jet kernels (csrc/fused_jet.cu) ----------------------------------------
#
# The kernels run their products in 3xTF32 like the decode (f32-grade, in
# another summation order than cuBLAS's). Against the plain twin run in
# float64 on the card: per quantity, the kernel may sit at most twice as
# far from it as the f32 twin does,
# |err| <= 1e-4 |ref| + atol max|ref| (a LeakyReLU mask that flips within
# f32 rounding moves a point's Jacobian and Hessian by a finite step, so
# the f32 floor is scale-relative), never below 1e-6 of max|ref|. Where the
# kernel flipped a mask that the f32 twin did not, the quantity passes if
# both hold: every mask where the kernel and float64 differ sits at a
# pre-activation within FLIP_REL of the layer's max |pre| of 0, and on the
# kernel's own masks (read from its workspace) the kernel is within that
# same rule of the float64 twin run on those masks.

FLIP_REL = 1e-5


def _atol_needed(got, want):
    got, want = got.detach().double(), want.detach().double()
    scale = float(want.abs().max())
    if scale == 0.0:
        return 0.0
    return max(0.0, float((got - want).abs().sub(1e-4 * want.abs()).max())
               / scale)


def _within(got, plain32, plain64):
    need, floor = _atol_needed(got, plain64), _atol_needed(plain32, plain64)
    return bool(torch.isfinite(got).all()) and need <= max(2 * floor, 1e-6)


def _flips_near_zero(kmasks, pres64):
    """Every kernel branch that differs from float64's lies within
    FLIP_REL of 0 (relative to the layer's largest pre-activation)."""
    for m, pre in zip(kmasks, pres64):
        pre = pre.reshape(m.shape)
        flip = m != (pre >= 0)
        if flip.any() and float(pre[flip].abs().max()) > \
                FLIP_REL * float(pre.abs().max()):
            return False
    return True


def _held(got, plain32, plain64, what, masked=None, flips_ok=False):
    """``masked``: (f32 twin, float64 twin) on the kernel's masks."""
    if _within(got, plain32, plain64):
        return
    assert flips_ok and masked is not None and \
        _within(got, *masked), (what, _atol_needed(got, plain64),
                                _atol_needed(plain32, plain64))


def _jet_inputs(device, nf, c, n, activation, seed=0, dim=3):
    from space_time_pde_torch.ops import fused_jet as fj

    torch.manual_seed(seed)
    imnet = ImNet(dim=dim, in_features=c, out_features=4, nf=nf,
                  activation=activation).to(device)
    with torch.no_grad():
        packed = fq.pack_imnet_params(imnet)
    rng = np.random.RandomState(seed)
    feats2 = torch.from_numpy(rng.randn(n * 2 ** dim, c).astype(np.float32))
    frac = rng.rand(n, dim).astype(np.float32)
    frac[: min(n, 4)] = np.array([[0, 0, 0, 0], [1, 1, 1, 1],
                                  [0, 1, 0.5, 1], [0.5, 0.5, 0.5, 0.5]]
                                 )[: min(n, 4), :dim]
    blocks = 1 + dim + dim * (dim + 1) // 2
    ybar = torch.from_numpy(rng.randn(n, blocks, 4).astype(np.float32))
    slope = fj.jet_slope(activation, 0.01)
    return (packed, feats2.to(device), torch.from_numpy(frac).to(device),
            ybar.to(device), slope)


JET_CASES = [(2, 4, 37, "leaky_relu", 3), (4, 8, 300, "relu", 3),
             (8, 16, 1000, "leaky_relu", 3), (64, 64, 2048, "leaky_relu", 3),
             (2, 4, 37, "leaky_relu", 4), (4, 8, 300, "relu", 4),
             (8, 16, 1000, "leaky_relu", 4), (64, 64, 1024, "leaky_relu", 4)]


@pytest.mark.parametrize("nf,c,n,activation,dim", JET_CASES)
def test_jet_kernels_match_plain(device, nf, c, n, activation, dim):
    from space_time_pde_torch.ops import fused_jet as fj

    packed, feats2, frac, ybar, slope = _jet_inputs(device, nf, c, n,
                                                    activation, dim=dim)
    p64 = {k: v.double() for k, v in packed.items()}
    f64, fr64 = feats2.double(), frac.double()
    kw = dict(nf=nf, slope=slope)
    fj.reset_launches()
    out, ws = fj.jet_fwd(feats2, frac, packed, **kw)
    dfeats, grads = fj.jet_bwd(feats2, frac, packed, ws, ybar, **kw)
    torch.cuda.synchronize()
    assert fj.LAUNCHES == {"jet_fwd": 1, "jet_bwd": 1}
    km = fj.workspace_masks(ws, n, dim, nf)
    want = fj.jet_fwd_plain(feats2, frac, packed, **kw)
    want64, pres64 = fj.jet_fwd_plain(f64, fr64, p64, return_pre=True, **kw)
    flips_ok = _flips_near_zero(km, pres64)
    del pres64
    want_m = fj.jet_fwd_plain(feats2, frac, packed, masks=km, **kw)
    want64_m = fj.jet_fwd_plain(f64, fr64, p64, masks=km, **kw)
    for blk in range(out.shape[1]):
        _held(out[:, blk], want[:, blk], want64[:, blk], f"block {blk}",
              (want_m[:, blk], want64_m[:, blk]), flips_ok)
    y64 = ybar.double()
    d32, g32 = fj.jet_bwd_plain(feats2, frac, packed, ybar, **kw)
    d64, g64 = fj.jet_bwd_plain(f64, fr64, p64, y64, **kw)
    d32m, g32m = fj.jet_bwd_plain(feats2, frac, packed, ybar, masks=km, **kw)
    d64m, g64m = fj.jet_bwd_plain(f64, fr64, p64, y64, masks=km, **kw)
    _held(dfeats, d32, d64, "dfeats2", (d32m, d64m), flips_ok)
    for name in grads:
        _held(grads[name], g32[name], g64[name], name,
              (g32m[name], g64m[name]), flips_ok)


@pytest.mark.parametrize("dim", [3, 4])
def test_jet_backward_is_deterministic(device, dim):
    """Parameter gradients are per-block partials summed in a fixed
    order: two runs agree bit for bit."""
    from space_time_pde_torch.ops import fused_jet as fj

    packed, feats2, frac, ybar, slope = _jet_inputs(device, 8, 16, 3000,
                                                    "leaky_relu", dim=dim)
    _, ws = fj.jet_fwd(feats2, frac, packed, nf=8)
    first = fj.jet_bwd(feats2, frac, packed, ws, ybar, nf=8)
    second = fj.jet_bwd(feats2, frac, packed, ws, ybar, nf=8)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    for name in first[1]:
        assert torch.equal(first[1][name], second[1][name]), name


@pytest.mark.parametrize("dim", [3, 4])
def test_fused_query_jet_trains_through_kernels(device, dim):
    """The autograd Function on the card (forward and backward kernels)
    against the same Function on the CPU (its plain twins)."""
    from space_time_pde_torch.ops import fused_jet as fj

    torch.manual_seed(3)
    imnet = ImNet(dim=dim, in_features=8, out_features=4, nf=4)
    rng = np.random.RandomState(3)
    latent = torch.from_numpy(
        rng.randn(2, *(4, 5, 6, 3)[:dim], 8).astype(np.float32))
    pts = torch.from_numpy(rng.rand(2, 50, dim).astype(np.float32))
    cot = [torch.from_numpy(rng.randn(2, 50, 4, *([dim] * i)).astype(
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


def test_jet_kernels_refuse_other_d(device):
    """D = 3 and D = 4 are the kernels' instantiations; D = 2 on the card
    raises, naming them."""
    from space_time_pde_torch.ops import fused_jet as fj

    imnet = ImNet(dim=2, in_features=4, out_features=2, nf=2).to(device)
    with pytest.raises(NotImplementedError, match=r"\(3, 4\)"):
        fj.fused_query_jet(imnet, torch.zeros(1, 3, 3, 4, device=device),
                           torch.zeros(1, 5, 2, device=device))
