"""The decode kernel's arithmetic, checked on the CPU before a card run.

``csrc/fused_query.cu`` runs its products in 3xTF32: each f32 operand x
splits into hi = tf32(x) and lo = tf32(x - hi) (round to nearest, 10
mantissa bits; the weights' lo is passed unrounded, so the tensor cores
truncate it), and a product a b becomes lo_a hi_b + hi_a lo_b +
hi_a hi_b; each k8 step's three products are summed and added to an f32
accumulator. It takes its weights in the padded, stacked
layout of ``fused_query.kernel_weights``. Here, in numpy and PyTorch on
the CPU:

- the kernel's layer decomposition over ``kernel_weights`` (layer 0 from
  the latents; layer i from ``[h_{i-1} | latents] @ [Wh_i ; Wx_feat]``;
  coordinate term and corner bias added after; blend before the head)
  reproduces the plain twin in float64, padding included, for
  activations that are not 0 at 0;
- with its products emulated in 3xTF32, the flagship model on data-like
  latents sits at most twice as far from the float64 twin as the f32
  twin does (the card check's rule, ``chip_smoke.py`` phases 3 and 10),
  where plain TF32 would not.

``csrc/fused_jet.cu`` runs the jet's products the same way (the
activations' lo rounded, the weights' not). Its forward, emulated layer
by layer over the chain rows with the kernel's K order, holds every jet
block of the committed rb2d (D = 3) and turb3d (D = 4) ImNets to the
card's rule of ``chip_smoke.py`` phases 4 and 11, and its backward's
largest product, the layer-1 weight gradient X_0^T P_1 over all chain
rows (split-K partials in the kernel's order), sits within twice the f32
product's distance from float64.
"""

import os

import numpy as np
import pytest
import torch

from space_time_pde_torch.bridge import load_exported, load_flax_params
from space_time_pde_torch.models import ImNet, UNet3d, UNet4d
from space_time_pde_torch.models.nonlinearities import get_activation
from space_time_pde_torch.ops import fused_jet as fj
from space_time_pde_torch.ops import fused_query as fq
from space_time_pde_torch.ops.grid_interp import _locate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "space_time_pde_torch", "assets",
                     "r5_rb2d_4x_e900_230400.npz")
TURB3D_ASSET = os.path.join(ROOT, "space_time_pde_torch", "assets",
                            "r5_turb3d_200x_big_76800.npz")
RTOL = 1e-4


def _tf32(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero (``cvt.rna.tf32.f32``)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x, round_lo=True):
    """(hi, lo): lo rounded to TF32, or (the kernel's weights) truncated,
    as the tensor cores read an unrounded f32 operand."""
    hi = _tf32(x)
    lo = x - hi
    if not round_lo:
        lo = (lo.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
        return hi, lo
    return hi, _tf32(lo)


def _mm_tf32x3(a, b, round_b_lo=False):
    """As the kernels: per k8 step the three products (small ones first),
    then that step's sum added to the f32 accumulator. ``round_b_lo``: B
    is an activation (the jet's TN product), its lo rounded like A's."""
    ah, al = _split(a.float().numpy())
    bh, bl = _split(b.float().numpy(), round_lo=round_b_lo)
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        sl = slice(k, k + 8)
        out += (al[:, sl] @ bh[sl] + ah[:, sl] @ bl[sl]) + ah[:, sl] @ bh[sl]
    return torch.from_numpy(out)


def _mm_tf32(a, b):
    return torch.from_numpy(_tf32(a.float().numpy()) @
                            _tf32(b.float().numpy()))


def _kernel_chain(kw, feats2, frac, *, nf, activation, matmul,
                  negative_slope=0.01):
    """The kernel's decomposition of the decode over its weight layout."""
    n, dim = frac.shape
    k = 2 ** dim
    c = feats2.shape[-1]
    cp = kw["wx0"].shape[0]
    act = get_activation(activation, negative_slope)
    feats = torch.nn.functional.pad(feats2, (0, cp - c))
    corner = torch.arange(n * k) % k
    point = torch.arange(n * k) // k
    off = 0

    def epilogue(acc, width):
        sl = slice(off, off + width)
        return act(acc + frac[point] @ kw["rel"][:, sl] + kw["cb"][corner, sl])

    h = epilogue(matmul(feats, kw["wx0"]).to(feats.dtype),
                 kw["wx0"].shape[1])
    off += h.shape[1]
    for i in range(1, 5):
        wb = kw[f"wb{i}"]
        h = epilogue(matmul(torch.cat([h, feats], 1), wb).to(feats.dtype),
                     wb.shape[1])
        off += wb.shape[1]
    h4 = h[:, :nf].reshape(n, k, nf)
    blended = (h4 * fq._corner_weights(frac)[..., None]).sum(1)
    return blended @ kw["w5"] + kw["b5"]


def _atol_needed(got, want):
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    return max(0.0, float(((got - want).abs() - RTOL * want.abs()).max())
               / scale)


@pytest.mark.parametrize("nf,c,dim,activation", [
    (2, 5, 3, "sigmoid"), (4, 8, 4, "softplus"), (3, 33, 2, "elu"),
    (64, 64, 3, "leaky_relu")])
def test_kernel_layout_reproduces_plain_twin(nf, c, dim, activation):
    torch.manual_seed(0)
    imnet = ImNet(dim=dim, in_features=c, out_features=4, nf=nf,
                  activation=activation)
    rng = np.random.RandomState(1)
    n = 37
    feats2 = torch.from_numpy(rng.randn(n * 2 ** dim, c))
    frac = torch.from_numpy(rng.rand(n, dim))
    with torch.no_grad():
        packed = {k: v.double() for k, v in
                  fq.pack_imnet_params(imnet).items()}
        kw = fq.kernel_weights(packed, nf=nf)
        want = fq.decode_blend_plain(feats2, frac, packed, nf=nf,
                                     n_corners=2 ** dim,
                                     activation=activation)
        got = _kernel_chain(kw, feats2, frac, nf=nf, activation=activation,
                            matmul=lambda a, b: a @ b)
    cp = -(-c // 32) * 32
    assert kw["wx0"].shape == (cp, -(-16 * nf // 64) * 64)
    assert kw["wb1"].shape[0] == kw["wx0"].shape[1] + cp
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.fixture(scope="module")
def flagship_inputs():
    """The committed flagship ImNet, latents from its UNet3d on 0.1 x
    N(0, 1) input at the training igres (data-like magnitudes, ~1e3, as
    ``test_torch_checkpoint.py``), and 1,024 points with their corner
    rows."""
    from space_time_pde_torch.utils.config import Config

    exported = load_exported(ASSET)
    m = Config.from_dict(exported["config"]).model
    igres = (4, 16, 16)
    unet = load_flax_params(
        UNet3d(m.in_channels, m.lat_dims, igres, nf=m.unet_nf, mf=m.unet_mf,
               negative_slope=m.negative_slope, activation=m.activation,
               norm=m.norm), exported["params"]["unet"]).eval()
    imnet = load_flax_params(
        ImNet(3, m.lat_dims, m.out_channels, m.imnet_nf, m.activation,
              m.negative_slope), exported["params"]["imnet"])
    rng = np.random.RandomState(0)
    lres = 0.1 * rng.randn(1, *igres, 4).astype(np.float32)
    pts = rng.rand(1024, 3).astype(np.float32)
    pts[:4] = [[0, 0, 0], [1, 1, 1], [0, 0.5, 1], [1, 0, 0.25]]
    with torch.no_grad():
        grid = unet(torch.from_numpy(lres))[0]
        cell, frac = _locate(torch.from_numpy(pts), igres, 0.0, 1.0)
        table = fq.cell_major_features(grid)
        feats2 = table[fq._flat_cells(cell, igres).long()].reshape(
            -1, grid.shape[-1])
        packed = fq.pack_imnet_params(imnet)
    return imnet, packed, feats2.contiguous(), frac.contiguous()


def test_tf32x3_within_twice_f32_of_float64(flagship_inputs):
    imnet, packed, feats2, frac = flagship_inputs
    kw = dict(nf=imnet.nf, activation=imnet.activation,
              negative_slope=imnet.negative_slope)
    with torch.no_grad():
        p64 = {k: v.double() for k, v in packed.items()}
        want64 = fq.decode_blend_plain(feats2.double(), frac.double(), p64,
                                       n_corners=8, **kw)
        plain32 = fq.decode_blend_plain(feats2, frac, packed, n_corners=8,
                                        **kw)
        layout = fq.kernel_weights(packed, nf=imnet.nf)
        emu = {name: _kernel_chain(layout, feats2, frac, matmul=mm, **kw)
               for name, mm in (("tf32x3", _mm_tf32x3), ("tf32", _mm_tf32))}
    need_f32 = _atol_needed(plain32, want64)
    need = {name: _atol_needed(v, want64) for name, v in emu.items()}
    print(f"atol needed vs float64 at rtol {RTOL:g} (x max|ref| "
          f"{float(want64.abs().max()):.4g}): f32 twin {need_f32:.3e}, "
          f"3xTF32 {need['tf32x3']:.3e}, TF32 {need['tf32']:.3e}")
    assert torch.isfinite(emu["tf32x3"]).all()
    assert need["tf32x3"] <= 2.0 * need_f32
    assert need["tf32"] > 2.0 * need_f32


# --- the jet kernels' products (csrc/fused_jet.cu) --------------------------

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
    """The jet forward kernel's decomposition: per layer one product over
    the chain planes [D+1][R] of X_{i-1} @ Wh_i, the primal's accumulator
    continuing over the latents (feats @ Wx_feat[:, sl_i], extra K steps);
    the coordinate term and corner bias added after, in f32; the primal's
    mask on every chain; the blend and head of the plain twin. ->
    (jet [N, blocks, O], the five layers' masks [R, w_i])."""
    n, dim = frac.shape
    k = 2 ** dim
    wxf, wxr, cb = packed["wx_feat"], packed["wx_rel"], packed["corner_bias"]
    point, corner = torch.arange(n * k) // k, torch.arange(n * k) % k
    off, x, masks = 0, None, []
    for i, mult in enumerate(fq._MULTS):
        sl = slice(off, off + nf * mult)
        off += nf * mult
        if i == 0:
            acc = [matmul(feats2, wxf[:, sl])] + [0.0] * dim
        else:
            wh = packed[f"wh{i}"]
            acc = [matmul(torch.cat([x[0], feats2], 1),
                          torch.cat([wh, wxf[:, sl]], 0))]
            acc += [matmul(x[c], wh) for c in range(1, dim + 1)]
        pre = acc[0]
        for d in range(dim):
            pre = pre + frac[point, d:d + 1] * wxr[d, sl]
        pre = pre + cb[corner, sl]
        masks.append(pre >= 0)
        m = torch.where(masks[-1], 1.0, slope)
        x = [m * pre] + [m * (acc[c] + wxr[c - 1, sl])
                         for c in range(1, dim + 1)]
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
        got, km = _jet_kernel_chain(packed, feats2, frac, matmul=_mm_tf32x3,
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
    256 points), as the TN kernel sums it: split-K chunks of 512 rows
    (chunk_rows at this size), each a run of 3xTF32 k8 steps with both
    operands' lo rounded, then the chunks in eight interleaved sums added
    in order (reduce_kernel)."""
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
    parts = [_mm_tf32x3(x0[z:z + 512].T, p1[z:z + 512], round_b_lo=True)
             for z in range(0, rows, 512)]
    sums = [sum(parts[q::8][1:], parts[q]) for q in range(8)]
    got = sums[0]
    for s in sums[1:]:
        got = got + s
    need, floor = _jet_atol(got, want64), _jet_atol(plain32, want64)
    print(f"X_0^T P_1 over {rows} chain rows: atol needed vs float64 "
          f"3xTF32 {need:.3e}, f32 {floor:.3e}")
    assert need <= 2.0 * floor



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
