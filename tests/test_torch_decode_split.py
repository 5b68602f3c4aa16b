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

The kernel now runs on ``wgmma`` over the weight image of
``fused_query.decode_tiles(compute_dtype=float32)``: the latents' skip
product folded into each layer's product (X = the latents), the
accumulator started at the coordinate term and corner bias in f32, the
weights split once on the host (both planes rounded to TF32), and each
k8 step's three products summed in a temporary that the tensor cores
truncate as they accumulate, then added to the accumulator (promoted).
The flagship check runs that arithmetic too (``_tile_chain``); the
mma.sync case stays as the reference it was.

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


def _rz32(x):
    """float64 -> f32 rounded toward zero."""
    r = x.astype(np.float32)
    return np.where(np.abs(r) > np.abs(x), np.nextafter(r, np.float32(0)),
                    r)


def _mm_tf32x3(a, b, round_b_lo=False, promoted=False, init=None):
    """As the kernels: per k8 step the three products (small ones first),
    then that step's sum added to the f32 accumulator. ``round_b_lo``: B's
    lo rounded like A's (the jet's TN product, whose B is an activation;
    the f32 decode's weights, split so on the host).

    ``promoted``: the f32 decode on wgmma (csrc/fused_query.cu): each k8
    step runs its 3 products into a temporary, each product's 8-term sum
    (exact) added to it and the sum truncated toward zero to f32, as the
    tensor cores accumulate; then the temporary is added to the f32
    accumulator (round to nearest), which starts at ``init`` (the f32
    decode's skip term) or 0. Vectorized over the steps."""
    ah, al = _split(a.float().numpy())
    bh, bl = _split(b.float().numpy(), round_lo=round_b_lo)
    if not promoted:
        out = np.zeros((a.shape[0], b.shape[1]), np.float32)
        for k in range(0, a.shape[1], 8):
            sl = slice(k, k + 8)
            out += (al[:, sl] @ bh[sl] + ah[:, sl] @ bl[sl]) + \
                ah[:, sl] @ bh[sl]
        return torch.from_numpy(out)
    m, kk = a.shape
    assert kk % 8 == 0, kk
    g = kk // 8

    def steps(x):                       # [m, K] -> [g, m, 8]
        return x.astype(np.float64).reshape(m, g, 8).transpose(1, 0, 2)

    def wsteps(y):                      # [K, n] -> [g, 8, n]
        return y.astype(np.float64).reshape(g, 8, -1)

    t = None
    for x, y in ((al, bh), (ah, bl), (ah, bh)):
        d = steps(x) @ wsteps(y)                          # [g, m, n]
        t = _rz32(d if t is None else t + d)
    out = (np.zeros((m, b.shape[1]), np.float32) if init is None
           else init.float().numpy().copy())
    for j in range(g):
        out += t[j]
    return torch.from_numpy(out)


def _mm_tf32(a, b):
    return torch.from_numpy(_tf32(a.float().numpy()) @
                            _tf32(b.float().numpy()))


def _trunc32(x):
    """float64 -> f32 rounded toward zero (the low 29 mantissa bits
    cleared, so the cast is exact in f32's normal range)."""
    return x.view(torch.int64).bitwise_and_(-(1 << 29)).view(
        torch.float64).float()


def _mm_promoted(a, b, init=None, rows=64):
    """The f32 jets' wgmma products (csrc/fused_jet.cu): both operands
    split into TF32 hi and lo (lo rounded), per k8 step (8 consecutive K)
    the three products' sum taken exactly and truncated toward zero to
    f32 (the tensor cores' accumulation, modelled as one truncation a step
    rather than one a product), then added to the f32 accumulator, which
    starts at ``init`` or 0 (promoted every step). K is padded to 8.
    Torch float64 in chunks of ``rows`` rows."""
    a, b = a.float(), b.float()
    m, k = a.shape
    n = b.shape[1]
    pad = -k % 8
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    g = (k + pad) // 8
    ah = fj._tf32(a)
    al = fj._tf32(a - ah)
    bh = fj._tf32(b)
    bl = fj._tf32(b - bh)
    bs = torch.cat([bh.reshape(g, 8, n), bl.reshape(g, 8, n),
                    bh.reshape(g, 8, n)], 1).double()
    out = torch.zeros(m, n) if init is None else init.float().clone()
    for r0 in range(0, m, rows):
        sl = slice(r0, r0 + rows)
        a3 = torch.cat([x[sl].reshape(-1, g, 8) for x in (al, ah, ah)], 2)
        t = _trunc32(torch.bmm(a3.double().transpose(0, 1), bs))
        acc = out[sl]
        for j in range(g):
            acc += t[j]
    return out


def _mm_f32_steps(a, b, rows=512):
    """The f32 yardstick of the decode's mma_sync / wgmma kernels in a
    fixed order: per k8 step (8 consecutive K) the exact sum of the step's
    f32 products rounded to f32 (to nearest), added to an f32 accumulator
    step after step, as the kernels sum their steps. Torch float64 in
    chunks of ``rows`` rows: unlike torch's f32 matmul, whose blocking
    follows the thread count, the sum does not depend on how many threads
    compute it."""
    a, b = a.float(), b.float()
    m, k = a.shape
    n = b.shape[1]
    pad = -k % 8
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    g = (k + pad) // 8
    bs = b.reshape(g, 8, n).double()
    out = torch.zeros(m, n)
    for r0 in range(0, m, rows):
        sl = slice(r0, r0 + rows)
        t = torch.bmm(a[sl].reshape(-1, g, 8).double().transpose(0, 1),
                      bs).float()
        acc = out[sl]
        for j in range(g):
            acc += t[j]
    return out


def _mm_stages(a, b, init=None):
    """:func:`_mm_promoted` with K in the f32 jet kernel's order for a
    row-major A: padded to whole 32-deep stages, each stage's columns
    taken in ``fj.F32_STEP_COLS`` order (k8 step s holds columns 8t + 2s
    and 8t + 2s + 1)."""
    k = a.shape[1]
    kp = -(-k // 32) * 32
    idx = torch.tensor([32 * kt + c for kt in range(kp // 32)
                        for c in fj.F32_STEP_COLS])
    a = torch.nn.functional.pad(a.float(), (0, kp - k))[:, idx]
    b = torch.nn.functional.pad(b.float(), (0, 0, 0, kp - k))[idx]
    return _mm_promoted(a, b, init)


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


def _flagship_inputs(threads):
    """The committed flagship ImNet, latents from its UNet3d on 0.1 x
    N(0, 1) input at the training igres (data-like magnitudes, ~1e3, as
    ``test_torch_checkpoint.py``), and 1,024 points with their corner
    rows. The UNet runs on ``threads`` threads, so that the latents (and
    the rule's limit on them) do not follow the machine's thread count."""
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
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        with torch.no_grad():
            grid = unet(torch.from_numpy(lres))[0]
    finally:
        torch.set_num_threads(before)
    with torch.no_grad():
        cell, frac = _locate(torch.from_numpy(pts), igres, 0.0, 1.0)
        table = fq.cell_major_features(grid)
        feats2 = table[fq._flat_cells(cell, igres).long()].reshape(
            -1, grid.shape[-1])
        packed = fq.pack_imnet_params(imnet)
    return imnet, packed, feats2.contiguous(), frac.contiguous()


@pytest.fixture(scope="module")
def flagship_inputs():
    """:func:`_flagship_inputs` on one thread."""
    return _flagship_inputs(1)


@pytest.fixture(scope="module")
def flagship_inputs_8():
    """:func:`_flagship_inputs` on eight threads (the latents the rule was
    first held on, on an eight-core machine)."""
    return _flagship_inputs(8)


def _tile_chain(packed, feats2, frac, *, nf, activation, matmul,
                negative_slope=0.01):
    """The f32 decode kernel's decomposition over its weight image's
    layer matrices (``fq._f32_layer_matrices``): per layer the accumulator
    starts at the skip term's coordinate part and corner bias in f32
    (``fq._f32_skip``), and one product of A = [X | h_{i-1}] (X = the
    latents, h in the kernel's permuted order within each 8-column block)
    with the layer's B adds to it (``matmul(a, b, init)``); K in the
    kernel's order (X, then h; layer 0's 64-column chunks are independent
    columns); the blend in f32 before the head."""
    n, dim = frac.shape
    nk = 2 ** dim
    c = feats2.shape[-1]
    mats = fq._f32_layer_matrices(packed, nf=nf)
    rel, cb = fq._f32_skip(packed, nf=nf)
    widths, kx = fq._f32_plan(c, nf)
    offs = np.cumsum([0] + widths)
    act = get_activation(activation, negative_slope)
    point, corner = torch.arange(n * nk) // nk, torch.arange(n * nk) % nk
    x = torch.zeros(n * nk, kx, dtype=feats2.dtype)
    x[:, :c] = feats2
    h = None
    for i in range(5):
        sl = slice(int(offs[i]), int(offs[i + 1]))
        skip = cb[corner, sl].to(x.dtype)
        for d in range(dim):
            skip = skip + frac[point, d:d + 1] * rel[d, sl].to(x.dtype)
        a = x
        if i:
            a = torch.cat([x, h[:, fq._f32_h_order(widths[i - 1])]], 1)
        h = act(matmul(a, mats[i].t().to(x.dtype), skip).to(x.dtype))
    h4 = h[:, :nf].reshape(n, nk, nf)
    blended = (h4 * fq._corner_weights(frac)[..., None]).sum(1)
    return blended @ packed["w5"].to(x.dtype) + packed["b5"].to(x.dtype)


# The f32 wgmma decode emulated on the flagship: the truncating
# accumulation runs in float64 over every product, so that case takes the
# first PROMOTE_POINTS of the fixture's points.
PROMOTE_POINTS = 128


def _tf32x3_rule(inputs, kernel):
    """The card's rule for the decode (chip_smoke.py phases 3 and 10) on
    the kernels' arithmetic: ``mma_sync``, the earlier kernel's order over
    ``kernel_weights`` (weights' lo truncated, every k8 step's sum added in
    f32), where plain TF32 fails the rule; ``wgmma_promote1``, the wgmma
    kernel's over its weight image, each k8 step's products promoted. The
    f32 yardstick sums in the kernels' k8-step order
    (:func:`_mm_f32_steps`), whatever the thread count."""
    imnet, packed, feats2, frac = inputs
    kw = dict(nf=imnet.nf, activation=imnet.activation,
              negative_slope=imnet.negative_slope)
    if kernel != "mma_sync":
        feats2, frac = feats2[:8 * PROMOTE_POINTS], frac[:PROMOTE_POINTS]
    with torch.no_grad():
        p64 = {k: v.double() for k, v in packed.items()}
        want64 = fq.decode_blend_plain(feats2.double(), frac.double(), p64,
                                       n_corners=8, **kw)
        layout = fq.kernel_weights(packed, nf=imnet.nf)
        plain32 = _kernel_chain(layout, feats2, frac, matmul=_mm_f32_steps,
                                **kw)
        # Torch's f32 products, the yardstick before the k8-step order,
        # printed beside it (not asserted).
        torch32 = fq.decode_blend_plain(feats2, frac, packed, n_corners=8,
                                        **kw)
        if kernel == "mma_sync":
            emu = {name: _kernel_chain(layout, feats2, frac, matmul=mm, **kw)
                   for name, mm in (("tf32x3", _mm_tf32x3),
                                    ("tf32", _mm_tf32))}
        else:
            emu = {"tf32x3": _tile_chain(
                packed, feats2, frac,
                matmul=lambda a, b, init: _mm_tf32x3(
                    a, b, round_b_lo=True, promoted=True, init=init), **kw)}
    need_f32 = _atol_needed(plain32, want64)
    need = {name: _atol_needed(v, want64) for name, v in emu.items()}
    print(f"{kernel}: atol needed vs float64 at rtol {RTOL:g} (x max|ref| "
          f"{float(want64.abs().max()):.4g}) on {torch.get_num_threads()} "
          f"thread(s): f32 twin {need_f32:.3e} (torch's f32 products "
          f"{_atol_needed(torch32, want64):.3e}), "
          + ", ".join(f"{k} {v:.3e}" for k, v in need.items()))
    assert torch.isfinite(emu["tf32x3"]).all()
    assert need["tf32x3"] <= 2.0 * need_f32
    if kernel == "mma_sync":
        assert need["tf32"] > 2.0 * need_f32


@pytest.mark.parametrize("kernel", ["mma_sync", "wgmma_promote1"])
def test_tf32x3_within_twice_f32_of_float64(flagship_inputs, kernel):
    """:func:`_tf32x3_rule` on latents made on one thread."""
    _tf32x3_rule(flagship_inputs, kernel)


@pytest.mark.parametrize("kernel", ["mma_sync", "wgmma_promote1"])
def test_tf32x3_within_twice_f32_of_float64_8_thread_latents(
        flagship_inputs_8, kernel):
    """:func:`_tf32x3_rule` on latents made on eight threads."""
    _tf32x3_rule(flagship_inputs_8, kernel)


def test_tf32x3_decode_rms_at_narrow_widths():
    """At C = nf = 16, D = 4 (a random-init ImNet, as
    ``scripts/f32_flip_check.py`` takes it) the wgmma decode's emulated
    arithmetic sits as far from float64 as f32 in the kernels' k8-step
    order does, in rms over every output, within the rule's 2x: where the
    kernel reads past the rule at these widths, a few outputs near 0 set
    the reading (``scripts/f32_decode_emulation.py``), not a product's
    error, which would move every output it feeds."""
    torch.manual_seed(0)
    imnet = ImNet(dim=4, in_features=16, out_features=4, nf=16,
                  activation="leaky_relu")
    rng = np.random.RandomState(0)
    n = 256
    feats2 = torch.from_numpy(rng.randn(n * 16, 16).astype(np.float32))
    frac = torch.from_numpy(rng.rand(n, 4).astype(np.float32))
    kw = dict(nf=16, activation="leaky_relu", negative_slope=0.01)
    with torch.no_grad():
        packed = fq.pack_imnet_params(imnet)
        p64 = {k: v.double() for k, v in packed.items()}
        want64 = fq.decode_blend_plain(feats2.double(), frac.double(), p64,
                                       n_corners=16, **kw)
        emu = _tile_chain(packed, feats2, frac, matmul=lambda a, b, init:
                          _mm_tf32x3(a, b, round_b_lo=True, promoted=True,
                                     init=init), **kw)
        f32 = _kernel_chain(fq.kernel_weights(packed, nf=16), feats2, frac,
                            matmul=_mm_f32_steps, **kw)
    rms = lambda x: float(((x.double() - want64) ** 2).mean().sqrt())
    print(f"C = nf = 16, D = 4: rms |x - float64| (max |float64| "
          f"{float(want64.abs().max()):.4g}): emulated wgmma {rms(emu):.3e}, "
          f"f32 k8-step order {rms(f32):.3e}")
    assert torch.isfinite(emu).all()
    assert rms(emu) <= 2.0 * rms(f32)


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
