"""The f32 jet kernels' arithmetic, checked on the CPU before a card run
(the 3xTF32 emulation of ``tf32x3_emulation.py``; the decode kernel's is
checked in ``test_torch_decode_split.py``).

``csrc/fused_jet.cu`` runs the jet's products on ``wgmma`` the same way
(every operand's lo rounded; each k8 step's products promoted into an f32
accumulator; the weights from ``ops/fused_jet.py::f32_weight_image``).
Its forward, emulated layer by layer over the chain rows with the
kernel's K order (``F32_STEP_COLS`` within each 32-deep stage; the
accumulators starting at the coordinate term and corner bias in f32),
holds every jet block of the committed rb2d (D = 3) and turb3d (D = 4)
ImNets to the card's rule of ``chip_smoke.py`` phases 4 and 11; its
backward's largest product, the layer-1 weight gradient X_0^T P_1 over
all chain rows (split-K partials of ``f32_tn_plan``'s chunks, summed in
reduce_kernel's order), sits within twice the f32 product's distance from
float64; and its chain products P_{i-1} = (P_i Wh_i^T) m_{i-1} with the
corner-bias sums over them (bias_grad_kernel's order) predict phase 4's
``corner_bias`` reading against its limit.
"""



import numpy as np
import pytest
import torch

from space_time_pde_torch.bridge import load_exported, load_flax_params
from space_time_pde_torch.models import ImNet, UNet3d, UNet4d
from space_time_pde_torch.ops import fused_jet as fj
from space_time_pde_torch.ops import fused_query as fq
from space_time_pde_torch.ops.grid_interp import _locate
from tf32x3_emulation import (
    ASSET, TURB3D_ASSET, RTOL, _mm_promoted, _mm_stages)

JET_SLACK, JET_FLOOR, FLIP_REL = 2.0, 1e-6, 1e-5


def _latent_inputs(unet, imnet, igres, n, seed):
    """Latents from ``unet`` on 0.1 x N(0, 1) input at ``igres``
    (data-like magnitudes) and n points' corner rows and fractions."""
    rng = np.random.RandomState(seed)
    lres = 0.1 * rng.randn(1, *igres, 4).astype(np.float32)
    pts = rng.rand(n, len(igres)).astype(np.float32)
    pts[0] = 0.0
    pts[1] = 1.0
    with torch.no_grad():
        grid = unet(torch.from_numpy(lres))[0]
        cell, frac = _locate(torch.from_numpy(pts), igres, 0.0, 1.0)
        table = fq.cell_major_features(grid)
        feats2 = table[fq._flat_cells(cell, igres).long()].reshape(
            -1, grid.shape[-1])
        packed = fq.pack_imnet_params(imnet)
    return packed, feats2.contiguous(), frac.contiguous()


@pytest.fixture(scope="module")
def jet_inputs():
    """{D: (nf, packed, feats2, frac)}: 256 points of the committed rb2d
    flagship (D = 3) and turb3d (D = 4) models."""
    from space_time_pde_torch.utils.config import Config

    out = {}
    exported = load_exported(ASSET)
    m = Config.from_dict(exported["config"]).model
    unet = load_flax_params(
        UNet3d(m.in_channels, m.lat_dims, (4, 16, 16), nf=m.unet_nf,
               mf=m.unet_mf, negative_slope=m.negative_slope,
               activation=m.activation, norm=m.norm),
        exported["params"]["unet"]).eval()
    imnet = load_flax_params(
        ImNet(3, m.lat_dims, m.out_channels, m.imnet_nf, m.activation,
              m.negative_slope), exported["params"]["imnet"])
    out[3] = (imnet.nf, *_latent_inputs(unet, imnet, (4, 16, 16), 256, 0))
    exported = load_exported(TURB3D_ASSET)
    t = exported["meta"]["turb3d_args"]
    unet = load_flax_params(
        UNet4d(in_features=4, out_features=t["lat_dims"], igres=(4, 8, 8, 8),
               nf=t["unet_nf"], mf=t["unet_mf"]),
        exported["params"]["unet"]).eval()
    imnet = load_flax_params(ImNet(4, t["lat_dims"], 4, t["imnet_nf"]),
                             exported["params"]["imnet"])
    out[4] = (imnet.nf, *_latent_inputs(unet, imnet, (4, 8, 8, 8), 256, 1))
    return out


def _jet_kernel_chain(packed, feats2, frac, *, nf, slope, matmul):
    """The f32 jet forward kernel's decomposition (csrc/fused_jet.cu,
    FwdLayer): per layer, the primal's accumulator starts at corner_bias +
    frac @ Wx_rel (each coordinate's term fused-multiply-added in order, in
    f32) and each tangent's at its Wx_rel row; the skip product feats @
    Wx_feat[:, sl_i] (K = C) adds to the primal's, then the hidden product
    X_{i-1} @ Wh_i (K = w_{i-1}) to every chain's (``matmul(a, b, init)``);
    the primal's mask on every chain; the blend and head of the plain twin.
    -> (jet [N, blocks, O], the five layers' masks [R, w_i])."""
    n, dim = frac.shape
    k = 2 ** dim
    wxf, wxr, cb = packed["wx_feat"], packed["wx_rel"], packed["corner_bias"]
    point, corner = torch.arange(n * k) // k, torch.arange(n * k) % k
    off, x, masks = 0, None, []
    for i, mult in enumerate(fq._MULTS):
        sl = slice(off, off + nf * mult)
        off += nf * mult
        init = cb[corner, sl].double()
        for d in range(dim):
            init = (init + frac[point, d:d + 1].double()
                    * wxr[d, sl].double()).float().double()
        acc = [matmul(feats2, wxf[:, sl], init.float())]
        tangents = [wxr[c, sl].expand(n * k, -1).contiguous()
                    for c in range(dim)]
        if i == 0:
            acc += tangents
        else:
            wh = packed[f"wh{i}"]
            acc = [matmul(x[0], wh, acc[0])]
            acc += [matmul(x[c], wh, tangents[c - 1])
                    for c in range(1, dim + 1)]
        masks.append(acc[0] >= 0)
        m = torch.where(masks[-1], 1.0, slope)
        x = [m * a for a in acc]
    h = x[0].reshape(n, k, nf)
    g = torch.stack(x[1:], 1).reshape(n, k, dim, nf)
    return fj._head(fj._stacked(h, g, frac), packed, lambda t: t), masks


def _jet_atol(got, want):
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    return max(0.0, float(((got - want).abs() - RTOL * want.abs()).max())
               / scale) if scale else 0.0


@pytest.mark.parametrize("dim", [3, 4])
def test_jet_tf32x3_within_twice_f32_of_float64(jet_inputs, dim):
    """The card rule of chip_smoke.py phases 4 and 11, per jet block: at
    most twice the f32 twin's distance from float64 (floor 1e-6 of
    max|ref|), or only LeakyReLU branches flipped within 1e-5 of their
    layer's max |pre| and the rule met on the kernel's own branches."""
    nf, packed, feats2, frac = jet_inputs[dim]
    slope = 0.01
    kw = dict(nf=nf, slope=slope)
    p64 = {k: v.double() for k, v in packed.items()}
    f64, fr64 = feats2.double(), frac.double()
    with torch.no_grad():
        got, km = _jet_kernel_chain(packed, feats2, frac, matmul=_mm_stages,
                                    **kw)
        plain32 = fj.jet_fwd_plain(feats2, frac, packed, **kw)
        want64, pres64 = fj.jet_fwd_plain(f64, fr64, p64, return_pre=True,
                                          **kw)
        plain32_m = fj.jet_fwd_plain(feats2, frac, packed, masks=km, **kw)
        want64_m = fj.jet_fwd_plain(f64, fr64, p64, masks=km, **kw)
    flips, near = 0, True
    for m, pre in zip(km, pres64):
        pre = pre.reshape(m.shape)
        flip = m != (pre >= 0)
        flips += int(flip.sum())
        if flip.any():
            near &= float(pre[flip].abs().max()) <= \
                FLIP_REL * float(pre.abs().max())
    assert torch.isfinite(got).all()
    for blk in range(got.shape[1]):
        need = _jet_atol(got[:, blk], want64[:, blk])
        limit = max(JET_SLACK * _jet_atol(plain32[:, blk], want64[:, blk]),
                    JET_FLOOR)
        if need <= limit:
            continue
        need_m = _jet_atol(got[:, blk], want64_m[:, blk])
        limit_m = max(JET_SLACK * _jet_atol(plain32_m[:, blk],
                                            want64_m[:, blk]), JET_FLOOR)
        assert near and need_m <= limit_m, (blk, need, limit, flips,
                                            need_m, limit_m)


def _chain_planes(packed, feats2, frac, nf):
    """Layer 0's chain planes [primal, tangent 1..D] (each [R, 16 nf]) in
    f32, the TN product's A operand."""
    n, dim = frac.shape
    wxf, wxr, cb = packed["wx_feat"], packed["wx_rel"], packed["corner_bias"]
    point = torch.arange(n * 2 ** dim) // 2 ** dim
    corner = torch.arange(n * 2 ** dim) % 2 ** dim
    sl = slice(0, 16 * nf)
    pre = feats2 @ wxf[:, sl] + frac[point] @ wxr[:, sl] + cb[corner, sl]
    m = torch.where(pre >= 0, 1.0, 0.01)
    return [m * pre] + [m * wxr[a, sl] for a in range(dim)]


def test_jet_weight_gradient_tf32x3_within_twice_f32_of_float64(jet_inputs):
    """dWh_1 = X_0^T P_1 over all 4 x 2,048 chain rows (rb2d flagship,
    256 points), as the TN product sums it: split-K chunks of
    ``f32_tn_plan`` (256 rows at this size), each a run of promoted 3xTF32
    k8 steps (8 rows a step, both operands' lo rounded), then the chunks in
    eight interleaved sums added in order (reduce_kernel)."""
    nf, packed, feats2, frac = jet_inputs[3]
    with torch.no_grad():
        _, pres = fj.jet_fwd_plain(feats2, frac, packed, nf=nf,
                                   return_pre=True)
        x0 = torch.cat(_chain_planes(packed, feats2, frac, nf))
    rows = x0.shape[0]
    rng = np.random.RandomState(5)
    m1 = torch.where(pres[1].reshape(-1, 8 * nf) >= 0, 1.0, 0.01).repeat(
        4, 1)
    p1 = torch.from_numpy(rng.randn(rows, 8 * nf).astype(np.float32)) * m1
    want64 = x0.double().T @ p1.double()
    plain32 = x0.T @ p1
    chunk = fj.f32_tn_plan(rows, 16 * nf, 8 * nf)[3]
    parts = [_mm_promoted(x0[z:z + chunk].T, p1[z:z + chunk])
             for z in range(0, rows, chunk)]
    assert len(parts) >= 8
    sums = [sum(parts[q::8][1:], parts[q]) for q in range(8)]
    got = sums[0]
    for s in sums[1:]:
        got = got + s
    need, floor = _jet_atol(got, want64), _jet_atol(plain32, want64)
    print(f"X_0^T P_1 over {rows} chain rows in {len(parts)} chunks of "
          f"{chunk}: atol needed vs float64 3xTF32 {need:.3e}, f32 "
          f"{floor:.3e}")
    assert need <= 2.0 * floor


def _head_backward(packed, frac, ybar, masks4, slope):
    """P_4 in f32 (the backward head kernel's sums, jet_common.cuh): ybar
    through W5 and spread over the chain rows by the blend's transpose,
    times layer 4's mask -> the chain planes [D + 1, R, nf]."""
    n, dim = frac.shape
    w, dw, d2w = (t.float() for t in fj.multilinear_weight_jet(frac))
    bars = ybar.float() @ packed["w5"].float().t()       # [N, blocks, nf]
    hbar = w[..., None] * bars[:, :1]
    for a in range(dim):
        hbar = hbar + dw[..., a, None] * bars[:, 1 + a, None]
    gbar = [w[..., None] * bars[:, 1 + a, None] for a in range(dim)]
    for i, (a, b) in enumerate(fj.tri_pairs(dim)):
        bh = bars[:, 1 + dim + i, None]
        if a != b:
            hbar = hbar + d2w[..., a, b, None] * bh
        gbar[b] = gbar[b] + dw[..., a, None] * bh
        gbar[a] = gbar[a] + dw[..., b, None] * bh
    m = torch.where(masks4.reshape(n, 2 ** dim, -1), 1.0, slope)
    planes = [hbar * m] + [g * m for g in gbar]
    return torch.stack([p.reshape(n * 2 ** dim, -1) for p in planes])


# Points of the chain-product emulation: the truncating accumulation runs
# in float64 over every product of the backward's chains.
CHAIN_POINTS = 256


def test_jet_corner_bias_tf32x3_within_twice_f32_of_float64():
    """Phase 4's ``corner_bias`` gradient (its D = 3 reading sat at 96% of
    the limit under the mma.sync kernel) on both kernels' arithmetic:
    chip_smoke.py's phase-4 inputs (the flagship ImNet, a seeded N(0, 1)
    latent grid of (4, 16, 16), its point mix) at CHAIN_POINTS points; the
    forward's masks from its emulation (:func:`_jet_kernel_chain`), P_4 from
    the head in f32, then P_{i-1} = (P_i Wh_i^T) m_{i-1} as the chain
    product runs it (promoted 3xTF32, K in the stage order), and
    corner_bias[k, sl_i] = sum_p P_i[p, k, primal] in bias_grad_kernel's
    order. Held as phase 4 holds it: within twice the f32 twin's distance
    from float64, or, where only branches flipped near 0 differ, within
    twice on the kernel's own branches. Both readings are printed."""
    import chip_smoke as cs

    imnet = cs.load_imnet(ASSET, 3, torch.device("cpu"))
    feats2, frac, packed, ybar, kw = cs.jet_inputs(
        imnet, torch.device("cpu"), (4, 16, 16), CHAIN_POINTS)
    nf, slope, dim = kw["nf"], kw["slope"], 3
    p64 = {k: v.double() for k, v in packed.items()}
    f64, fr64, y64 = feats2.double(), frac.double(), ybar.double()
    with torch.no_grad():
        _, km = _jet_kernel_chain(packed, feats2, frac, matmul=_mm_stages,
                                  **kw)
        planes = _head_backward(packed, frac, ybar, km[4], slope)
        sums = [None] * 5
        for i in range(4, -1, -1):
            prim = planes[0].reshape(CHAIN_POINTS, 2 ** dim, -1)
            sums[i] = torch.from_numpy(_bias_sums_tree(prim.numpy()))
            if i:
                w = planes.shape[-1]
                nxt = _mm_stages(planes.reshape(-1, w),
                                 packed[f"wh{i}"].t())
                m = torch.where(km[i - 1], 1.0, slope)
                planes = nxt.reshape(dim + 1, -1, nxt.shape[-1]) * m
        _, pres64 = fj.jet_fwd_plain(f64, fr64, p64, return_pre=True, **kw)
    got = torch.cat(sums, dim=-1)
    flips, near = 0, True
    for m, pre in zip(km, pres64):
        flip = m != (pre.reshape(m.shape) >= 0)
        flips += int(flip.sum())
        if flip.any():
            near &= float(pre.reshape(m.shape)[flip].abs().max()) <= \
                FLIP_REL * float(pre.abs().max())
    readings = {}
    for what, masks in (("float64's branches", None),
                        ("the kernel's branches", km)):
        g32 = fj.jet_bwd_plain(feats2, frac, packed, ybar, masks=masks,
                               **kw)[1]["corner_bias"]
        g64 = fj.jet_bwd_plain(f64, fr64, p64, y64, masks=masks,
                               **kw)[1]["corner_bias"]
        need, floor = _jet_atol(got, g64), _jet_atol(g32, g64)
        limit = max(JET_SLACK * floor, JET_FLOOR)
        readings[what] = need <= limit
        print(f"corner_bias over {CHAIN_POINTS} phase-4 points (D = 3), "
              f"on {what}: atol needed vs float64: kernel {need:.3e}, f32 "
              f"twin {floor:.3e}; {need / limit:.3f} of the limit "
              f"{limit:.3e} ({flips} kernel branches differ from "
              f"float64's)")
    assert torch.isfinite(got).all()
    assert readings["float64's branches"] or (
        near and readings["the kernel's branches"])


# The jet backward's bias-side sums (csrc/fused_jet.cu, bias_grad_kernel
# and reduce_kernel): corner_bias[k] = sum_p P[p, k], in f32.
_TARGET_BLOCKS, _REDUCE_WARPS = 4 * 132, 8


def _cdiv(a, b):
    return -(-a // b)


def _reduce_chunks(parts):
    """reduce_kernel: warp q sums chunks q, q + 8, ... in order; the
    warps' sums are added in warp order."""
    sums = []
    for q in range(_REDUCE_WARPS):
        s = np.zeros(parts.shape[1:], np.float32)
        for z in range(q, len(parts), _REDUCE_WARPS):
            s = s + parts[z]
        sums.append(s)
    out = sums[0]
    for s in sums[1:]:
        out = out + s
    return out


def _bias_sums_serial(p):
    """The earlier order: 128 column threads a block, each chunk's points
    one after another, then reduce_kernel."""
    n, w = p.shape[0], p.shape[-1]
    chunks = min(_cdiv(2 * _TARGET_BLOCKS, _cdiv(_cdiv(w, 4), 128)), n)
    ppc = _cdiv(n, chunks)
    parts = []
    for z in range(_cdiv(n, ppc)):
        s = np.zeros(p.shape[1:], np.float32)
        for q in range(z * ppc, min(n, (z + 1) * ppc)):
            s = s + p[q]
        parts.append(s)
    return _reduce_chunks(np.stack(parts))


def _bias_sums_tree(p, lanes=8):
    """The kernel's order: 32 column threads by 8 point lanes a block;
    lane y sums the chunk's points y, y + 8, ... in order, the lanes are
    added pairwise (y + 4, then y + 2, then 1), then reduce_kernel."""
    n, w = p.shape[0], p.shape[-1]
    chunks = min(_cdiv(2 * _TARGET_BLOCKS, _cdiv(_cdiv(w, 4), 32)),
                 _cdiv(n, lanes))
    ppc = _cdiv(n, chunks)
    parts = []
    for z in range(_cdiv(n, ppc)):
        lo, hi = z * ppc, min(n, (z + 1) * ppc)
        acc = [np.zeros(p.shape[1:], np.float32) for _ in range(lanes)]
        for y in range(lanes):
            for q in range(lo + y, hi, lanes):
                acc[y] = acc[y] + p[q]
        half = lanes // 2
        while half:
            for y in range(half):
                acc[y] = acc[y] + acc[y + half]
            half //= 2
        parts.append(acc[0])
    return _reduce_chunks(np.stack(parts))


@pytest.mark.parametrize("n", [2048, 8192])
def test_jet_bias_sums_tree_no_farther_from_float64(n):
    """corner_bias's sums over n points of the flagship's layer-0 planes
    (8 corners x 1,024 columns; a per-rank count of the data x space step
    and the flagship step's 8,192): the kernel's per-block tree sits no
    farther from float64 than the serial chunk order it replaced (and
    both well inside one f32 run over all the points, numpy's sum along
    the point axis)."""
    rng = np.random.RandomState(n)
    mask = np.where(rng.rand(n, 8, 1024) < 0.5, 1.0, 0.01)
    p = (rng.randn(n, 8, 1024) * mask + 0.05).astype(np.float32)
    want = p.astype(np.float64).sum(0)
    tree = _bias_sums_tree(p)
    serial = _bias_sums_serial(p)
    one_run = p.sum(0)           # numpy adds the rows one after another

    def need(got):
        # Largest distance from float64, a fraction of max |ref| (rtol 0:
        # the order's own rounding, not the card check's rule).
        return float(np.abs(got - want).max() / np.abs(want).max())

    print(f"corner_bias sums over {n} points: distance from float64: "
          f"tree {need(tree):.3e}, serial {need(serial):.3e}, one run "
          f"{need(one_run):.3e}")
    assert need(tree) <= need(serial) < need(one_run)
