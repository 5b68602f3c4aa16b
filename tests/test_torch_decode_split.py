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

The jet kernels' arithmetic is checked in ``test_torch_jet_split.py``;
the emulation both use is ``tf32x3_emulation.py``.
"""

import numpy as np
import pytest
import torch

from space_time_pde_torch.bridge import load_exported, load_flax_params
from space_time_pde_torch.models import ImNet, UNet3d
from space_time_pde_torch.models.nonlinearities import get_activation
from space_time_pde_torch.ops import fused_query as fq
from space_time_pde_torch.ops.grid_interp import _locate
from tf32x3_emulation import (
    ASSET, RTOL, _mm_tf32x3, _mm_tf32, _mm_f32_steps, _kernel_chain,
    _atol_needed)


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
