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
"""

import os

import numpy as np
import pytest
import torch

from space_time_pde_torch.bridge import load_exported, load_flax_params
from space_time_pde_torch.models import ImNet, UNet3d
from space_time_pde_torch.models.nonlinearities import get_activation
from space_time_pde_torch.ops import fused_query as fq
from space_time_pde_torch.ops.grid_interp import _locate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, "space_time_pde_torch", "assets",
                     "r5_rb2d_4x_e900_230400.npz")
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


def _mm_tf32x3(a, b):
    """As the kernel: per k8 step the three products (small ones first),
    then that step's sum added to the f32 accumulator."""
    ah, al = _split(a.float().numpy())
    bh, bl = _split(b.float().numpy(), round_lo=False)
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
