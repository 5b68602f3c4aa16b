"""On-card checks of the CUDA kernels (decode, jet and the rb2d data
generator's tridiagonal solve) against their plain twins, and of the
turb3d data CLI's card path against the numpy copy.

Marked ``cuda``: without a card every test skips (a CUDA kernel has no
CPU mode). On a machine with one, from the repo root:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures jax, which that
machine does not have; this file imports only torch and the port.)

Decode tolerance rtol = atol = 1e-4 against the f32 twin: the kernel
runs its products in 3xTF32 on wgmma (f32-grade operands, each k8 step's
products promoted into an f32 accumulator), sums in another order than
cuBLAS and blends before the head in its own order. At the flagship
widths it is also held to the plain twin run in float64: at most twice
as far from it as the f32 twin,
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
    for src in ("fused_query", "fused_query_bf16", "fused_jet"):
        print(f"{src}.cu:\n{log.get(src, '')}")


# A block is 64 corner rows: 8 points at D = 3, 4 at D = 4. The edge cases
# take n = 1, one short of a block, one past it and a multiple of it.
EDGES = [(p, dim) for dim, b in ((3, 8), (4, 4))
         for p in (1, b - 1, b + 1, 4 * b)]
CASES = ([(4, 8, 3, 257, a) for a in NONLINEARITIES]
         + [(8, 8, 2, 100, "leaky_relu"), (2, 4, 4, 33, "elu"),
            (16, 16, 3, 300, "leaky_relu"), (32, 24, 4, 300, "gelu"),
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
                           "decode_blend_gather_bf16": 0,
                           "decode_blend_bf16": 0}
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    np.testing.assert_allclose(got2.cpu().numpy(), want.cpu().numpy(), **TOL)


# The bf16 instantiation against its bf16 twin: both round at the same
# points, but a sum taken in another order can land a bf16 value on the
# other side of a step, so the rule is four bf16 steps of max |twin|.
BF16_DIRECT = 4 * 2.0 ** -8


@pytest.mark.parametrize("nf,c,dim,n,activation", CASES)
def test_bf16_kernel_matches_plain(device, nf, c, dim, n, activation):
    """Both entries' bf16 instantiations (the gather kernel and the
    pre-gathered one, which rounds at other points) against their bf16
    twins."""
    packed, table, cell_flat, frac = _inputs(device, nf, c, dim, n,
                                             activation)
    table = table.to(torch.bfloat16)
    kw = dict(nf=nf, activation=activation, negative_slope=0.01,
              compute_dtype=torch.bfloat16)
    want = fq.decode_blend_gather_plain(table, cell_flat, frac, packed, **kw)
    feats2 = table[cell_flat.long()].reshape(-1, c).contiguous()
    want2 = fq.decode_blend_plain(feats2, frac, packed, n_corners=2 ** dim,
                                  **kw)
    fq.reset_launches()
    got = fq.decode_blend_gather(table, cell_flat, frac, packed, **kw)
    got2 = fq.decode_blend(feats2, frac, packed, n_corners=2 ** dim, **kw)
    torch.cuda.synchronize()
    assert fq.LAUNCHES == {"decode_blend_gather": 0, "decode_blend": 0,
                           "decode_blend_gather_bf16": 1,
                           "decode_blend_bf16": 1}
    for g, w in ((got, want), (got2, want2)):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        err = float((g - w).abs().max())
        assert err <= BF16_DIRECT * float(w.abs().max()), err


@pytest.mark.parametrize("dim", [3, 4])
def test_bf16_kernel_within_twice_twin_of_float64(device, dim):
    """At the flagship widths each bf16 decode kernel sits at most twice
    as far from the float64 f32-function as its bf16 twin does."""
    packed, table, cell_flat, frac = _inputs(device, 64, 64, dim, 4096,
                                             "leaky_relu")
    p64 = {k: v.double() for k, v in packed.items()}
    want64 = fq.decode_blend_gather_plain(table.double(), cell_flat,
                                          frac.double(), p64, nf=64)
    tb = table.to(torch.bfloat16)
    feats2 = tb[cell_flat.long()].reshape(-1, 64).contiguous()
    kw = dict(nf=64, compute_dtype=torch.bfloat16)
    pairs = (
        (fq.decode_blend_gather(tb, cell_flat, frac, packed, **kw),
         fq.decode_blend_gather_plain(tb, cell_flat, frac, packed, **kw)),
        (fq.decode_blend(feats2, frac, packed, n_corners=2 ** dim, **kw),
         fq.decode_blend_plain(feats2, frac, packed, n_corners=2 ** dim,
                               **kw)))
    torch.cuda.synchronize()
    for got, twin in pairs:
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


def _f32_plan(dim, c=64, nf=64):
    import ctypes

    buf = (ctypes.c_longlong * 8)()
    _build.load().stpde_decode_plan(c, dim, nf, buf)
    return dict(zip(("smem", "stages", "kx", "image", "cluster", "rows",
                     "base", "slot"), list(buf)))


# The f32 kernel's largest C at each widths' base (nf 16, 32, 64).
F32_C_LIMITS = {16: 712, 32: 520, 64: 136}


def test_shared_memory_overflow_raises(device):
    """The f32 kernel's plan must fit 227 KB with at least 2 ring slots
    beside H (64 x 8 base f32) and X (64 x kx f32, kx = C padded to 8).
    nf = 64 decodes and nf = 65 is refused (on the host, which cannot lay
    out its image, and by the kernel, given nf = 64's image); at each base
    the largest C decodes and the next one (kx 8 more) is refused: its plan
    keeps 2 slots and passes 227 KB. The refused launch's CUDA error is
    raised, and the next launch runs."""
    assert fq.block_points(3, device) == _build.load().stpde_block_rows() // 8
    assert fq.block_points(4, device) == 4
    rows16 = _build.load("fused_query_bf16").stpde_block_rows_bf16()
    assert fq.block_points(3, device, torch.bfloat16) == rows16 // 8
    assert fq.block_points(4, device, torch.bfloat16) == rows16 // 16
    limits = []
    for nf, c in F32_C_LIMITS.items():
        for dim in (3, 4):
            assert _f32_plan(dim, c=c, nf=nf)["smem"] <= 232448
            over = _f32_plan(dim, c=c + 1, nf=nf)
            assert over["smem"] > 232448 and over["stages"] == 2
        limits += [(nf, c, True), (nf, c + 1, False)]
    for nf, c, fits in [(64, 8, True), (65, 8, False)] + limits:
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
        elif nf > 64:
            with pytest.raises(ValueError, match="nf <= 64"):
                fq.decode_blend_gather(table, cell_flat, frac, packed, nf=nf)
            packed64, _, _, _ = _inputs(device, 64, c, 3, 16, "leaky_relu")
            tiles = fq.decode_tiles(packed64, nf=64, dim=3,
                                    compute_dtype=torch.float32)
            out = torch.empty(16, 4, device=device)
            code = _build.load().stpde_decode_blend_gather(
                table.data_ptr(), cell_flat.data_ptr(), frac.data_ptr(),
                tiles.image.data_ptr(), tiles.image.numel(),
                tiles.w5.data_ptr(), tiles.b5.data_ptr(), out.data_ptr(),
                16, table.shape[0], c, 3, nf, 4, 1, 0.01,
                torch.cuda.current_stream().cuda_stream)
            with pytest.raises(RuntimeError, match="CUDA error"):
                _build.check(code, "decode_blend_gather at nf = 65")
        else:
            with pytest.raises(RuntimeError, match="CUDA error"):
                fq.decode_blend_gather(table, cell_flat, frac, packed, nf=nf)


def test_f32_plan_matches_host_mirror(device):
    """The C plan's kx, widths' base and weight-image size equal the
    host's (``fq._f32_plan``, the image ``decode_tiles`` builds), at
    flagship and test widths."""
    for c, nf, dim in ((64, 64, 3), (64, 64, 4), (5, 2, 2), (33, 3, 4),
                       (16, 32, 3), (16, 16, 4), (32, 24, 3)):
        plan = _f32_plan(dim, c=c, nf=nf)
        widths, kx = fq._f32_plan(c, nf)
        packed, _, _, _ = _inputs(device, nf, c, dim, 1, "leaky_relu")
        tiles = fq.decode_tiles(packed, nf=nf, dim=dim,
                                compute_dtype=torch.float32)
        assert (plan["kx"], plan["image"], plan["base"]) == \
            (kx, tiles.image.numel(), widths[-1]), (c, nf, dim)


def _f32_both(device, nf, c, dim, n, seed=0):
    """Both f32 entries' kernel outputs (one weight image) and the twin."""
    packed, table, cell_flat, frac = _inputs(device, nf, c, dim, n,
                                             "leaky_relu", seed=seed)
    tiles = fq.decode_tiles(packed, nf=nf, dim=dim,
                            compute_dtype=torch.float32)
    feats2 = table[cell_flat.long()].reshape(-1, c).contiguous()
    got = (fq.decode_blend_gather(table, cell_flat, frac, packed, nf=nf,
                                  tiles=tiles),
           fq.decode_blend(feats2, frac, packed, nf=nf, n_corners=2 ** dim,
                           tiles=tiles))
    want = fq.decode_blend_gather_plain(table, cell_flat, frac, packed,
                                        nf=nf)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("dim", [3, 4])
def test_f32_kernel_ragged_n(device, dim):
    """n = 1, fewer points than a tile, fewer than a cluster's tiles, and
    n past a whole number of clusters' tiles: every point against the
    twin, nothing written past n."""
    plan = _f32_plan(dim)
    ppt = plan["rows"] >> dim
    cluster_pts = ppt * plan["cluster"]
    for n in (1, ppt - 1, cluster_pts - 1, 3 * cluster_pts + ppt + 1):
        got, want = _f32_both(device, 64, 64, dim, n)
        for g in got:
            assert g.shape == (n, 4) and bool(torch.isfinite(g).all()), n
            np.testing.assert_allclose(g.cpu().numpy(), want.cpu().numpy(),
                                       **TOL)


@pytest.mark.parametrize("dim", [3, 4])
def test_f32_kernel_is_deterministic(device, dim):
    """Two launches of each f32 entry give the same bits (every row is
    computed and written once, whichever CTA takes its tile)."""
    first, _ = _f32_both(device, 64, 64, dim, 20000, seed=3)
    second, _ = _f32_both(device, 64, 64, dim, 20000, seed=3)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_f32_out_of_range_cell_decodes_nan_in_its_row(device):
    """Cell ids past the table and below 0, in the middle of a run of
    tiles: NaN in those points' rows only, every other point as the twin
    decodes it."""
    packed, table, cell_flat, frac = _inputs(device, 64, 64, 3, 1000,
                                             "leaky_relu")
    bad = [5, 517, 999]
    cell_flat[bad[0]] = table.shape[0]
    cell_flat[bad[1]] = -1
    cell_flat[bad[2]] = 2 ** 30
    got = fq.decode_blend_gather(table, cell_flat, frac, packed, nf=64)
    ok = torch.ones(1000, dtype=torch.bool, device=device)
    ok[bad] = False
    good = cell_flat.clone()
    good[bad] = 0
    want = fq.decode_blend_gather_plain(table, good, frac, packed, nf=64)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got).any(dim=1), ~ok)
    assert bool(torch.isnan(got[~ok]).all())
    np.testing.assert_allclose(got[ok].cpu().numpy(),
                               want[ok].cpu().numpy(), **TOL)


# --- the bf16 decode kernel (csrc/fused_query_bf16.cu) ---------------------
#
# A CTA decodes 64 corner rows at a time (8 points at D = 3, 4 at D = 4) in
# clusters of stpde_decode_bf16_plan's size, persistent over the tiles.


def _bf16_plan(dim, pre, c=64, nf=64):
    import ctypes

    buf = (ctypes.c_longlong * 6)()
    _build.load("fused_query_bf16").stpde_decode_bf16_plan(c, dim, nf,
                                                           int(pre), buf)
    return dict(zip(("smem", "stages", "kx", "image", "cluster", "rows"),
                    list(buf)))


def _bf16_both(device, nf, c, dim, n, seed=0):
    """Both bf16 entries' kernel outputs and twins on the same points."""
    packed, table, cell_flat, frac = _inputs(device, nf, c, dim, n,
                                             "leaky_relu", seed=seed)
    table = table.to(torch.bfloat16)
    kw = dict(nf=nf, compute_dtype=torch.bfloat16)
    feats2 = table[cell_flat.long()].reshape(-1, c).contiguous()
    k = 2 ** dim
    got = (fq.decode_blend_gather(table, cell_flat, frac, packed, **kw),
           fq.decode_blend(feats2, frac, packed, n_corners=k, **kw))
    want = (fq.decode_blend_gather_plain(table, cell_flat, frac, packed,
                                         **kw),
            fq.decode_blend_plain(feats2, frac, packed, n_corners=k, **kw))
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("dim", [3, 4])
def test_bf16_kernel_ragged_n(device, dim):
    """n = 1, fewer points than a tile, fewer than a cluster's tiles, and
    n past a whole number of clusters' tiles: every point against its twin
    by the BF16_DIRECT rule, nothing written past n."""
    plan = _bf16_plan(dim, False)
    ppt = plan["rows"] >> dim
    cluster_pts = ppt * plan["cluster"]
    for n in (1, ppt - 1, cluster_pts - 1, 3 * cluster_pts + ppt + 1):
        got, want = _bf16_both(device, 64, 64, dim, n)
        for g, w in zip(got, want):
            assert g.shape == (n, 4) and bool(torch.isfinite(g).all()), n
            err = float((g - w).abs().max())
            assert err <= BF16_DIRECT * float(w.abs().max()), (n, err)


def test_bf16_out_of_range_cell_decodes_nan_in_its_row(device):
    """Cell ids past the table and below 0, in the middle of a run of
    tiles: NaN in those points' rows only, every other point as its twin
    decodes it."""
    packed, table, cell_flat, frac = _inputs(device, 64, 64, 3, 1000,
                                             "leaky_relu")
    bad = [5, 517, 999]
    cell_flat[bad[0]] = table.shape[0]
    cell_flat[bad[1]] = -1
    cell_flat[bad[2]] = 2 ** 30
    tb = table.to(torch.bfloat16)
    kw = dict(nf=64, compute_dtype=torch.bfloat16)
    got = fq.decode_blend_gather(tb, cell_flat, frac, packed, **kw)
    ok = torch.ones(1000, dtype=torch.bool, device=device)
    ok[bad] = False
    good = cell_flat.clone()
    good[bad] = 0
    want = fq.decode_blend_gather_plain(tb, good, frac, packed, **kw)
    torch.cuda.synchronize()
    nan_rows = torch.isnan(got).any(dim=1)
    assert torch.equal(nan_rows, ~ok)
    assert bool(torch.isnan(got[~ok]).all())
    err = float((got[ok] - want[ok]).abs().max())
    assert err <= BF16_DIRECT * float(want[ok].abs().max()), err


@pytest.mark.parametrize("dim", [3, 4])
def test_bf16_kernel_is_deterministic(device, dim):
    """Two launches of each bf16 entry give the same bits (every row is
    computed and written once, whichever CTA takes its tile)."""
    first, _ = _bf16_both(device, 64, 64, dim, 20000, seed=3)
    second, _ = _bf16_both(device, 64, 64, dim, 20000, seed=3)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bf16_kernel_limits_raise(device):
    """The plan must fit 227 KB with at least 3 ring stages. At nf = 64,
    D = 3 the gather entry decodes C = 181 (kx = 192) and refuses C = 182
    (kx = 208); nf = 64 decodes and nf = 65 (h_0 padded to 2048 columns)
    is refused; the pre-gathered entry (three bf16 pieces of each corner
    bias) decodes C = 165 and refuses C = 166. Each refused launch raises
    its CUDA error, and the launch after it runs."""
    assert _bf16_plan(3, False, c=181)["smem"] <= 232448
    assert _bf16_plan(3, False, c=182)["smem"] > 232448
    assert _bf16_plan(3, True, c=165)["smem"] <= 232448
    assert _bf16_plan(3, True, c=166)["smem"] > 232448
    for nf, c, pre, fits in ((64, 181, False, True), (64, 182, False, False),
                             (8, 181, False, True), (64, 8, False, True),
                             (65, 8, False, False), (64, 165, True, True),
                             (64, 166, True, False), (8, 16, True, True)):
        packed, table, cell_flat, frac = _inputs(device, nf, c, 3, 40,
                                                 "leaky_relu")
        tb = table.to(torch.bfloat16)
        feats2 = tb[cell_flat.long()].reshape(-1, c).contiguous()
        kw = dict(nf=nf, compute_dtype=torch.bfloat16)
        if pre:
            run = lambda: fq.decode_blend(feats2, frac, packed, n_corners=8,
                                          **kw)
            twin = lambda: fq.decode_blend_plain(feats2, frac, packed,
                                                 n_corners=8, **kw)
        else:
            run = lambda: fq.decode_blend_gather(tb, cell_flat, frac,
                                                 packed, **kw)
            twin = lambda: fq.decode_blend_gather_plain(tb, cell_flat, frac,
                                                        packed, **kw)
        if fits:
            got, want = run(), twin()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            assert err <= BF16_DIRECT * float(want.abs().max()), (nf, c, err)
        else:
            with pytest.raises(RuntimeError, match="CUDA error"):
                run()


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


def _flips_near_zero(kmasks, pres, rel=FLIP_REL):
    """Every kernel branch that differs from the reference's (whose
    pre-activations are ``pres``) lies within ``rel`` of 0 (relative to
    the layer's largest pre-activation)."""
    for m, pre in zip(kmasks, pres):
        pre = pre.reshape(m.shape)
        flip = m != (pre >= 0)
        if flip.any() and float(pre[flip].abs().max()) > \
                rel * float(pre.abs().max()):
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
    assert fj.LAUNCHES == {"jet_fwd": 1, "jet_bwd": 1,
                           "jet_fwd_bf16": 0, "jet_bwd_bf16": 0}
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
    assert fj.LAUNCHES == {"jet_fwd": 1, "jet_bwd": 1,
                           "jet_fwd_bf16": 0, "jet_bwd_bf16": 0}
    for g, w in zip(got, grads(torch.device("cpu"))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=3e-4,
                                   atol=3e-4 * float(w.abs().max()))


# Corner rows an item of the f32 product kernel (csrc/fused_jet.cu, a wgmma
# m64 tile): 8 points at D = 3, 4 at D = 4. A persistent wave is one item
# per SM.
F32_JET_ROWS = 64


@pytest.mark.parametrize("dim", [3, 4])
def test_f32_jet_ragged_n(device, dim):
    """n around the item: one point, one point short of an item, one past
    it, and a count whose items are not a multiple of a persistent wave
    (the card's SMs) and whose last item is ragged."""
    ppi = F32_JET_ROWS >> dim
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for n in (1, ppi - 1, ppi + 1, (sms + 1) * ppi + 3):
        test_jet_kernels_match_plain(device, 8, 16, n, "leaky_relu", dim)


@pytest.mark.parametrize("dim", [3, 4])
def test_f32_jet_forward_is_deterministic(device, dim):
    """Two forward launches give the same bits: the jet and the whole
    workspace (every layer's chains and masks, the weight image)."""
    from space_time_pde_torch.ops import fused_jet as fj

    packed, feats2, frac, _, _ = _jet_inputs(device, 64, 64, 3000,
                                             "leaky_relu", dim=dim)
    first = fj.jet_fwd(feats2, frac, packed, nf=64)
    second = fj.jet_fwd(feats2, frac, packed, nf=64)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.parametrize("nf,c,dim", [(64, 64, 3), (64, 64, 4), (3, 5, 3),
                                      (16, 4, 4), (2, 64, 3)])
def test_f32_jet_image_and_plans_match_host_mirrors(device, nf, c, dim):
    """The weight image that the forward splits on the card equals
    ``ops/fused_jet.py::f32_weight_image`` bit for bit, where
    ``f32_image_layout`` puts it; the library's ring and split-K plans
    (``stpde_jet_f32_ring``, ``stpde_jet_f32_tn_plan``) are the mirrors
    that the CPU tests follow."""
    import ctypes

    from space_time_pde_torch.ops import fused_jet as fj

    packed, feats2, frac, _, _ = _jet_inputs(device, nf, c, 37,
                                             "leaky_relu", dim=dim)
    _, ws = fj.jet_fwd(feats2, frac, packed, nf=nf)
    torch.cuda.synchronize()
    lib = _build.load("fused_jet")
    buf = (ctypes.c_longlong * 5)()
    lib.stpde_jet_f32_image_layout(37, c, dim, nf, buf)
    assert tuple(buf[:2]) == fj.f32_image_layout(37, c, dim, nf)
    got = fj.workspace_image(ws, 37, c, dim, nf).cpu()
    want = fj.f32_weight_image({k: v.cpu() for k, v in packed.items()},
                               nf=nf, dim=dim)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for mt in (1, 2, 4, 5):
        for kn in (32, 64):
            for staging in (0, 1):
                lib.stpde_jet_f32_ring(mt, kn, staging, buf)
                assert tuple(buf[:3]) == fj.f32_ring(mt, kn, bool(staging))
                assert buf[3] == 384
    for m in (8, 296, 1184, 65536, 262144, 327680):
        for ka, nb in ((1, 1), (16, 8), (64, 1024), (128, 64),
                       (1024, 512), (16384, 8192)):
            lib.stpde_jet_f32_tn_plan(m, ka, nb, buf)
            assert tuple(buf) == fj.f32_tn_plan(m, ka, nb), (m, ka, nb)


def test_jet_kernels_refuse_other_d(device):
    """D = 3 and D = 4 are the kernels' instantiations; D = 2 on the card
    raises, naming them."""
    from space_time_pde_torch.ops import fused_jet as fj

    imnet = ImNet(dim=2, in_features=4, out_features=2, nf=2).to(device)
    with pytest.raises(NotImplementedError, match=r"\(3, 4\)"):
        fj.fused_query_jet(imnet, torch.zeros(1, 3, 3, 4, device=device),
                           torch.zeros(1, 5, 2, device=device))


# --- the bf16 jet kernels (csrc/fused_jet_bf16.cu) ---------------------------
#
# Against their bf16 twins (jet_fwd_plain at bf16, jet_bwd_bf16_plain), by
# the decode's direct rule: every block and gradient within BF16_DIRECT of
# its max |twin|. A sum taken in another order can round a skip term to the
# other bf16 step, which can move a pre-activation near 0 to the other
# LeakyReLU branch: such a flip passes if every branch on which the kernel
# and the twin differ has a twin pre-activation within BF16_FLIP_REL of its
# layer's max |pre|, and on the kernel's own branches (read from its
# workspace) the kernel meets the direct rule against the twin run on them.

BF16_FLIP_REL = 2.0 ** -6
BF16 = torch.bfloat16


def _bf16_packed(packed):
    return {k: v.to(BF16) if k in fq._ROUNDED else v
            for k, v in packed.items()}


def _direct(got, want):
    return bool(torch.isfinite(got).all()) and float(
        (got.float() - want.float()).abs().max()) <= \
        BF16_DIRECT * float(want.float().abs().max())


# Points a forward block holds: 32 corner rows, 4 points at D = 3 and 2 at
# D = 4; the edges take one point, one short of a block and one past it.
# C = 4 and widths below 8 take the unaligned (2-byte) staging.
BF16_JET_CASES = ([(8, 16, n, "leaky_relu", 3) for n in (1, 3, 5, 17)]
                  + [(8, 16, n, "leaky_relu", 4) for n in (1, 3, 9)]
                  + [(2, 4, 37, "leaky_relu", 3), (2, 4, 37, "relu", 4),
                     (4, 4, 50, "leaky_relu", 3), (4, 4, 50, "leaky_relu", 4),
                     (64, 64, 2048, "leaky_relu", 3),
                     (64, 64, 1024, "leaky_relu", 4)])


@pytest.mark.parametrize("nf,c,n,activation,dim", BF16_JET_CASES)
def test_bf16_jet_kernels_match_twins(device, nf, c, n, activation, dim):
    _bf16_jet_check(device, nf, c, n, activation, dim)


def _bf16_jet_check(device, nf, c, n, activation, dim):
    """Both bf16 jet kernels, one launch each, against their twins by the
    direct rule (or on the kernel's own branches where only flips near 0
    differ)."""
    from space_time_pde_torch.ops import fused_jet as fj

    packed, feats2, frac, ybar, slope = _jet_inputs(device, nf, c, n,
                                                    activation, dim=dim)
    p16, f16 = _bf16_packed(packed), feats2.to(BF16)
    kw = dict(nf=nf, slope=slope)
    fj.reset_launches()
    out, ws = fj.jet_fwd(f16, frac, p16, compute_dtype=BF16, **kw)
    dfeats, grads = fj.jet_bwd(f16, frac, p16, ws, ybar, compute_dtype=BF16,
                               **kw)
    torch.cuda.synchronize()
    assert fj.LAUNCHES == {"jet_fwd": 0, "jet_bwd": 0, "jet_fwd_bf16": 1,
                           "jet_bwd_bf16": 1}
    assert dfeats.dtype == torch.float32
    km = fj.workspace_masks(ws, n, dim, nf, compute_dtype=BF16)
    twin, pres = fj.jet_fwd_plain(f16, frac, p16, compute_dtype=BF16,
                                  return_pre=True, **kw)
    flips_ok = _flips_near_zero(km, pres, BF16_FLIP_REL)
    twin_m = fj.jet_fwd_plain(f16, frac, p16, compute_dtype=BF16, masks=km,
                              **kw)
    d, g = fj.jet_bwd_bf16_plain(f16, frac, p16, ybar, **kw)
    dm, gm = fj.jet_bwd_bf16_plain(f16, frac, p16, ybar, masks=km, **kw)
    for what, got, want, want_m in (
            [("blocks", out, twin, twin_m), ("dfeats2", dfeats, d, dm)]
            + [(k, grads[k], g[k], gm[k]) for k in grads]):
        assert _direct(got, want) or (flips_ok and _direct(got, want_m)), \
            what


@pytest.mark.parametrize("dim", [3, 4])
def test_bf16_jet_backward_is_deterministic(device, dim):
    from space_time_pde_torch.ops import fused_jet as fj

    packed, feats2, frac, ybar, _ = _jet_inputs(device, 8, 16, 3000,
                                                "leaky_relu", dim=dim)
    p16, f16 = _bf16_packed(packed), feats2.to(BF16)
    _, ws = fj.jet_fwd(f16, frac, p16, nf=8, compute_dtype=BF16)
    first = fj.jet_bwd(f16, frac, p16, ws, ybar, nf=8, compute_dtype=BF16)
    second = fj.jet_bwd(f16, frac, p16, ws, ybar, nf=8, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    for name in first[1]:
        assert torch.equal(first[1][name], second[1][name]), name


@pytest.mark.parametrize("dim", [3, 4])
def test_fused_query_jet_bf16_trains_through_kernels(device, dim):
    """The bf16 jet's autograd Function on the card (the bf16 kernels)
    against the same on the CPU (their twins), gradients of the ImNet and
    the latent grid by the direct rule."""
    from space_time_pde_torch.ops import fused_jet as fj

    torch.manual_seed(4)
    imnet = ImNet(dim=dim, in_features=8, out_features=4, nf=4)
    rng = np.random.RandomState(4)
    latent = torch.from_numpy(
        rng.randn(2, *(4, 5, 6, 3)[:dim], 8).astype(np.float32))
    pts = torch.from_numpy(rng.rand(2, 50, dim).astype(np.float32))
    cot = [torch.from_numpy(rng.randn(2, 50, 4, *([dim] * i)).astype(
        np.float32)) for i in range(3)]

    def grads(dev):
        model = copy.deepcopy(imnet).to(dev)
        lat = latent.to(dev).requires_grad_(True)
        outs = fj.fused_query_jet(model, lat, pts.to(dev),
                                  compute_dtype=BF16)
        sum((o * c.to(dev)).sum() for o, c in zip(outs, cot)).backward()
        return [lat.grad.cpu()] + [p.grad.cpu() for p in model.parameters()]

    fj.reset_launches()
    got = grads(device)
    assert fj.LAUNCHES == {"jet_fwd": 0, "jet_bwd": 0, "jet_fwd_bf16": 1,
                           "jet_bwd_bf16": 1}
    for g, w in zip(got, grads(torch.device("cpu"))):
        assert _direct(g, w)


# Corner rows an item of the bf16 product kernel (csrc/fused_jet_bf16.cu,
# a wgmma m64 tile): 8 points at D = 3, 4 at D = 4. A persistent wave is
# one item per SM.
BF16_JET_ROWS = 64


@pytest.mark.parametrize("dim", [3, 4])
def test_bf16_jet_ragged_n(device, dim):
    """n around the item: one point, one point short of an item, one past
    it, and a count whose items are not a multiple of a persistent wave
    (the card's SMs) and whose last item is ragged."""
    ppi = BF16_JET_ROWS >> dim
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for n in (1, ppi - 1, ppi + 1, (sms + 1) * ppi + 3):
        _bf16_jet_check(device, 8, 16, n, "leaky_relu", dim)


@pytest.mark.parametrize("dim", [3, 4])
def test_bf16_jet_forward_is_deterministic(device, dim):
    """Two forward launches give the same bits: the jet and the whole
    workspace (every layer's chains and masks)."""
    from space_time_pde_torch.ops import fused_jet as fj

    packed, feats2, frac, _, _ = _jet_inputs(device, 64, 64, 3000,
                                             "leaky_relu", dim=dim)
    p16, f16 = _bf16_packed(packed), feats2.to(BF16)
    first = fj.jet_fwd(f16, frac, p16, nf=64, compute_dtype=BF16)
    second = fj.jet_fwd(f16, frac, p16, nf=64, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_bf16_jet_nf_limit_raises(device):
    """nf = 1024 (a 16,384-wide layer 0) runs and matches the twins; nf =
    1025 is refused (the wrapper raises), and the launch after it runs."""
    from space_time_pde_torch.ops import fused_jet as fj

    _bf16_jet_check(device, 1024, 8, 5, "leaky_relu", 3)
    packed, feats2, frac, _, _ = _jet_inputs(device, 1025, 8, 5,
                                             "leaky_relu")
    with pytest.raises(ValueError, match="rejects"):
        fj.jet_fwd(feats2.to(BF16), frac, _bf16_packed(packed), nf=1025,
                   compute_dtype=BF16)
    del packed
    _bf16_jet_check(device, 8, 16, 9, "leaky_relu", 3)


def test_bf16_jet_plans_match_host_mirrors(device):
    """The library's ring and split-K plans (``stpde_jet_bf16_ring``,
    ``stpde_jet_bf16_tn_plan``) are ``ops/fused_jet.py``'s mirrors, which
    the CPU schedule tests follow."""
    import ctypes

    from space_time_pde_torch.ops import fused_jet as fj

    lib = _build.load("fused_jet_bf16")
    buf = (ctypes.c_longlong * 5)()
    for mt in (1, 2, 4, 5):
        for staging in (0, 1):
            lib.stpde_jet_bf16_ring(mt, staging, buf)
            assert tuple(buf[:3]) == fj.bf16_ring(mt, bool(staging))
            assert buf[3] == 384
    for m in (8, 296, 1184, 65536, 262144, 327680):
        for ka, nb in ((1, 1), (16, 8), (64, 1024), (128, 64),
                       (1024, 512), (16384, 8192)):
            lib.stpde_jet_bf16_tn_plan(m, ka, nb, buf)
            assert tuple(buf) == fj.bf16_tn_plan(m, ka, nb), (m, ka, nb)


# ------------------------------------------------- the captured train step

def _tiny_train(device, family, policy, tmp_path=None):
    """(loss over a tiny seeded model's modules, optimizer, state, host
    batch maker) on ``device``: rb2d (UNet3d) or turb3d (UNet4d), f32 or
    ``use_bf16`` with ``pde_bf16`` (the bf16 jets)."""
    from space_time_pde_torch import physics as tphys
    from space_time_pde_torch import train as ttrain
    from space_time_pde_torch.utils.config import Config

    cfg = Config()
    cfg.model.lat_dims, cfg.model.unet_nf, cfg.model.imnet_nf = 8, 4, 2
    cfg.train.alpha_pde, cfg.train.pde_loss_type = 0.1, "huber"
    cfg.model.use_bf16 = cfg.train.pde_bf16 = policy == "bf16_pde"
    rng = np.random.RandomState(3)
    kw = dict(mean=rng.randn(4), std=0.5 + rng.rand(4))
    if family == "rb2d":
        igres = (4, 8, 8)
        pde = tphys.get_pde_layer("rb2d", t_crop=0.75, z_crop=0.5,
                                  x_crop=0.5, rayleigh=1e4, prandtl=1.0,
                                  **kw)
    else:
        igres = (4, 4, 4, 4)
        cfg.model.unet_mf = 8
        pde = tphys.get_pde_layer("ns3d", t_crop=0.7, z_crop=2.0,
                                  y_crop=2.5, x_crop=3.0, viscosity=1e-2,
                                  **kw)
    unet, imnet = ttrain.build_models(cfg, igres, device)
    opt = ttrain.make_optimizer(cfg)
    state = ttrain.init_state(0, unet, imnet, opt)
    loss_fn = ttrain.make_loss_fn(cfg, unet, imnet, pde)

    def batch(seed, inner=1, nan=False):
        r = np.random.RandomState(seed)
        steps = [{"lres": r.randn(2, *igres, 4).astype(np.float32),
                  "point_coord": r.rand(2, 64, len(igres)).astype(
                      np.float32),
                  "point_value": r.randn(2, 64, 4).astype(np.float32)}
                 for _ in range(inner)]
        if nan:
            steps[0]["lres"][0, 1, 1, 1] = np.nan
        return steps[0] if inner == 1 else {
            k: np.stack([s[k] for s in steps]) for k in steps[0]}

    return loss_fn, opt, state, batch


def _written(state):
    from space_time_pde_torch.train import COUNTERS

    out = {f"param/{k}": p for k, p in state.params().items()}
    for m in ("mu", "nu"):
        out.update({f"{m}/{k}": v for k, v in state.opt_state[m].items()})
    out.update({k: state.opt_state[k] for k in COUNTERS})
    return out


@pytest.mark.parametrize("inner", [1, 3])
@pytest.mark.parametrize("policy", ["f32", "bf16_pde"])
@pytest.mark.parametrize("family", ["rb2d", "turb3d"])
def test_captured_step_equals_eager_step(device, family, policy, inner):
    """``CapturedStep`` (warm-up, capture, replays) against the eager step
    over 4 dispatches from the same seeded state, one batch holding a
    NaN: every parameter, moment, counter and metric bit for bit. The jet
    wrappers count the eager launches alone: 4 dispatches' eager, the
    captured step's warm-up (its capture and replays launch nothing from
    Python)."""
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.train import (
        CapturedStep, make_multi_step, make_train_step)

    runs = []
    for captured in (False, True):
        loss_fn, opt, state, batch = _tiny_train(device, family, policy)
        step = (CapturedStep(loss_fn, opt, inner, device) if captured else
                make_train_step(loss_fn, opt) if inner == 1 else
                make_multi_step(loss_fn, opt, inner))
        fj.reset_launches()
        for i in range(4):
            b = {k: torch.from_numpy(v).to(device)
                 for k, v in batch(10 + i, inner, nan=i == 1).items()}
            state, metrics = step(state, b)
        torch.cuda.synchronize()
        assert not captured or step.graph is not None
        runs.append((_written(state), metrics, dict(fj.LAUNCHES), state.step))
    (want, wm, wl, ws), (got, gm, gl, gs) = runs
    jets = ("jet_fwd_bf16", "jet_bwd_bf16") if policy == "bf16_pde" else (
        "jet_fwd", "jet_bwd")
    assert gs == ws == 4 * inner
    assert [wl[k] for k in jets] == [4 * inner] * 2
    assert [gl[k] for k in jets] == [inner] * 2
    assert int(got["total_notfinite"]) == 1
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k in wm:
        assert torch.equal(gm[k], wm[k]), k


@pytest.mark.parametrize("policy", ["f32", "bf16_pde"])
@pytest.mark.parametrize("family", ["rb2d", "turb3d"])
def test_eager_step_makes_no_host_sync(device, family, policy):
    """One eager step (after a first one) under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing in the step reads
    the card from the host, so a CUDA graph can hold it."""
    from space_time_pde_torch.train import make_train_step

    loss_fn, opt, state, batch = _tiny_train(device, family, policy)
    step = make_train_step(loss_fn, opt)
    b = {k: torch.from_numpy(v).to(device) for k, v in batch(1).items()}
    state, _ = step(state, b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = step(state, b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_device_sampled_step_captures(device, tmp_path):
    """The train CLIs' loss on a card: batches assembled by the
    ``DeviceSampler`` inside the step. Captured equals eager bit for bit,
    no host sync in the eager step, and a ``refresh`` of a corrupted
    field is what the graph reads next."""
    from space_time_pde_torch.data import save_npz, taylor_green_fields
    from space_time_pde_torch.data.dataset import RB2DataLoader
    from space_time_pde_torch.data.device_pipeline import DeviceSampler
    from space_time_pde_torch.train import CapturedStep, make_train_step

    save_npz(str(tmp_path / "tg.npz"), taylor_green_fields(nt=10, nz=16,
                                                           nx=32))
    ds = RB2DataLoader(data_folder=str(tmp_path), data_filename="tg.npz",
                       nt=8, nz=16, nx=16, n_samp_pts_per_crop=64,
                       downsamp_t=2, downsamp_xz=2)
    rng = np.random.RandomState(0)
    draws = [DeviceSampler(ds, "cpu").draw(rng, 2) for _ in range(4)]
    runs = []
    for captured in (False, True):
        loss_fn, opt, state, _ = _tiny_train(device, "rb2d", "f32")
        sampler = DeviceSampler(ds, device)
        loss_fn = sampler.wrap_loss(loss_fn)
        step = (CapturedStep(loss_fn, opt, 1, device) if captured
                else make_train_step(loss_fn, opt))
        for i, (o, p) in enumerate(draws):
            b = {"origins": torch.from_numpy(o).to(device),
                 "point_coord": torch.from_numpy(p).to(device)}
            if not captured and i == 2:
                torch.cuda.set_sync_debug_mode("error")
            try:
                if i == 3:
                    sampler.data.fill_(float("nan"))
                    sampler.refresh()
                state, metrics = step(state, b)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        runs.append((_written(state), metrics))
    (want, wm), (got, gm) = runs
    assert int(got["total_notfinite"]) == 0
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k in wm:
        assert torch.equal(gm[k], wm[k]), k


# --- the rb2d data generator: the tridiagonal kernel (csrc/tridiag.cu) ---


@pytest.mark.parametrize("nx,nz", [(512, 128), (88, 16)])
@pytest.mark.parametrize("op", ["_psi_op", "_p_op"])
def test_tridiag_kernel_matches_plain(device, nx, nz, op):
    """The kernel against ``thomas_plain`` on the solver's Dirichlet and
    pinned Neumann operators, at the 512 x 128 grid's 128 x 257 and a
    ragged 16 x 45: within 1e-13 of max |x| (both do numpy's operations
    in numpy's order), one launch counted."""
    from space_time_pde_torch.data.rb2_solver import RB2Solver
    from space_time_pde_torch.ops import tridiag as td

    s = RB2Solver(nx, nz, 4.0, 1.0, 1e6, 1.0, 0, device)
    rng = np.random.RandomState(nz)
    nk = nx // 2 + 1
    rhs = torch.from_numpy(rng.randn(nz, nk)
                           + 1j * rng.randn(nz, nk)).to(device)
    before = td.LAUNCHES["tridiag"]
    got = td.tridiag(rhs, *getattr(s, op))
    want = td.thomas_plain(rhs, *getattr(s, op))
    torch.cuda.synchronize()
    assert td.LAUNCHES["tridiag"] == before + 1
    assert float((got - want).abs().max()) <= \
        1e-13 * float(want.abs().max())


def _rb2_pair(device):
    from space_time_pde_torch.data.rb2_solver import RB2Solver

    a, b = (RB2Solver(64, 32, 4.0, 1.0, 1e5, 1.0, 0, device)
            for _ in range(2))
    dt = min(0.2 * a.dx, 0.2 * a.dz, 0.2 * a.dz ** 2 / max(a.R, a.P))
    return a, b, dt


def test_rb2_solver_captured_equals_eager(device):
    """Two replays of a 5-step graph equal 10 eager steps bit for bit;
    the wrapper counts the graph's 10 solves as recorded, not launched."""
    from space_time_pde_torch.ops import tridiag as td

    eager, cap, dt = _rb2_pair(device)
    td.reset_launches()
    graph = cap.capture(5, dt)
    assert td.CAPTURED["tridiag"] == 10
    assert td.LAUNCHES["tridiag"] == 2      # the warm-up step
    for _ in range(2):
        for _ in range(5):
            eager.step(dt)
        graph.replay()
        torch.cuda.synchronize()
        for k in ("b", "zeta", "psi"):
            assert torch.equal(getattr(cap, k), getattr(eager, k)), k


def test_rb2_simulate_counts_its_replays(device):
    """``simulate_rb2d`` on the card replays its snapshot interval's
    graph once an interval of the transient and once a snapshot, and
    counts each replay; the remainder of the transient and the snapshots'
    solves are launched from Python."""
    from space_time_pde_torch.data import rb2_solver as rb
    from space_time_pde_torch.ops import tridiag as td

    s, _, dt = _rb2_pair(device)
    n_tr, n_per = int(round(0.5 / dt)), max(1, int(round(0.05 / dt)))
    td.reset_launches()
    rb.reset_replays()
    out = rb.simulate_rb2d(nx=64, nz=32, rayleigh=1e5, t_transient=0.5,
                           n_snapshots=3, snap_dt=0.05, device=device)
    assert out["b"].shape == (3, 32, 64)
    assert rb.REPLAYS["interval"] == n_tr // n_per + 3
    assert td.CAPTURED["tridiag"] == 2 * n_per
    assert td.LAUNCHES["tridiag"] == 2 + 2 * (n_tr % n_per) + 2 * 3


def test_rb2_solver_card_matches_numpy(device):
    """100 steps from seed 0 at 64 x 32 against the port's numpy copy of
    the solver: every field within 1e-10 of its max |numpy|."""
    from space_time_pde_torch.data import generator as gen

    s, _, dt = _rb2_pair(device)
    ref = gen._RB2Solver(64, 32, 4.0, 1.0, 1e5, 1.0, 0)
    for _ in range(100):
        s.step(dt)
        ref.step(dt)
    u, w = s.velocities()
    ru, rw = ref.velocities()
    for got, want in ((s.b, ref.b), (s.zeta, ref.zeta), (s.psi, ref.psi),
                      (u, ru), (w, rw)):
        got = got.cpu().numpy()
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("family", ["rb2d", "turb3d"])
def test_captured_step_counts_replayed_launches(device, family):
    """Over 4 dispatches of 8 steps a ``CapturedStep`` launches each jet 32
    times: 8 from Python (the warm-up), 8 recorded by the capture
    (``CAPTURED``) and 3 replays of them (``REPLAYED``)."""
    from space_time_pde_torch.ops import fused_jet as fj
    from space_time_pde_torch.train import (
        REPLAYED, CapturedStep, reset_replayed)

    loss_fn, opt, state, batch = _tiny_train(device, family, "f32")
    step = CapturedStep(loss_fn, opt, 8, device)
    fj.reset_launches()
    reset_replayed()
    for i in range(4):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in batch(10 + i, 8).items()}
        state, _ = step(state, b)
    torch.cuda.synchronize()
    for k in ("jet_fwd", "jet_bwd"):
        assert (fj.LAUNCHES[k], fj.CAPTURED[k], REPLAYED[k]) == (8, 8, 24), k
    assert step.recorded == {"jet_fwd": 8, "jet_bwd": 8}


def test_turb3d_data_cli_on_the_card(device, tmp_path):
    """``experiments/turb3d/generate_data_torch.py`` on the card (its
    default device), seed 7 at its default flags: the numpy copy's schema
    and scalars, every field within 2^-22 of its max |value| from the
    numpy copy's."""
    import importlib.util
    import os

    from space_time_pde_torch.data import generator as gen

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "generate_data_torch",
        os.path.join(root, "experiments", "turb3d", "generate_data_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    out = tmp_path / "beltrami_s7.npz"
    cli.main(["--seed", "7", "--out", str(out)])
    want = gen.beltrami_fields(7)
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if np.ndim(v):
            assert np.abs(got[k] - v).max() <= 2.0 ** -22 * np.abs(v).max(), k
        else:
            assert got[k] == v, k


def test_turb3d_step_gradient_median_within_jax(device):
    """``chip_smoke.py`` phase 14's turb3d step (the recipe's widths, the
    seeded weights, the exported batch) through the captured step: phase
    8's rule, and the median over the leaves of each leaf's rel-L2
    distance from float64 over JAX f32's at most ``STEP_MEDIAN`` (it read
    1.73 with UNet4d's temporal product summed in f32)."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg, pde, opt, state, batch, ref, ref_spec = cs.reference_step(
        cs.TURB3D_STEP_REF, device)
    state, metrics, _ = cs.captured_step_once(cfg, pde, opt, state, batch)
    bad = cs.check_step(state, metrics, ref, ref_spec, "", verbose=False,
                        median_limit=cs.STEP_MEDIAN)
    assert not bad, bad
