"""The bf16 decode kernel's host-side weight image and schedule, on the CPU.

``ops/fused_query.py::decode_tiles`` lays every layer's weights out as the
kernel (``csrc/fused_query_bf16.cu``) reads them: stage after stage of
``_bf16_schedule``, each in wgmma's K-major, no-swizzle shared-memory
image of B. Here the image is read back and held, exactly, against
``kernel_weights(dtype=bfloat16)`` (the gather entry's form, and the
pre-gathered entry's with ``corner_bias`` f32), and a PyTorch emulation
drives the image in the kernel's schedule (X = [latents | bf16(frac) |
corner one-hots] first, then h; kPre's skip term rounded after X's last
k16 step; ragged last stages) and is held against both bf16 twins at
rtol 1e-5 of max |twin|, as ``test_bf16_kernel_layout_emulated``
(tests/test_torch_bf16.py) holds the layout it replaced.
"""

import numpy as np
import pytest
import torch

from space_time_pde_torch.models import ImNet
from space_time_pde_torch.ops import fused_query as fq

BF = torch.bfloat16
# (C, nf): the flagship widths, test widths, and widths that pad (C not a
# multiple of 8, layers narrower than 32).
WIDTHS = [(64, 64), (8, 8), (5, 4)]


def _packed(dim, c, nf, seed=0):
    torch.manual_seed(seed)
    imnet = ImNet(dim=dim, in_features=c, out_features=4, nf=nf)
    with torch.no_grad():
        return fq.pack_imnet_params(imnet)


def _layer_blocks(tiles, widths, kx):
    """Each layer's ``[W_i, K_i]`` B^T read back from the image."""
    mats = [torch.zeros(w, kx + (widths[i - 1] if i else 0))
            for i, w in enumerate(widths)]
    at = 0
    image = tiles.image.float()
    for layer, c0, np_, k0, kn in fq._bf16_schedule(widths, kx):
        blk = image[at:at + np_ * kn].reshape(kn // 16, np_ // 8, 2, 8, 8)
        mats[layer][c0:c0 + np_, k0:k0 + kn] = blk.permute(
            1, 3, 0, 2, 4).reshape(np_, kn)
        at += np_ * kn
    assert at == tiles.image.numel()
    return mats


@pytest.mark.parametrize("pregathered", [False, True])
@pytest.mark.parametrize("dim", [3, 4])
@pytest.mark.parametrize("c,nf", WIDTHS)
def test_tile_image_round_trips_to_kernel_weights(c, nf, dim, pregathered):
    """Every value of ``kernel_weights(dtype=bf16)`` (``f32=("b5", "cb")``
    for the pre-gathered entry) sits where the kernel reads it, the f32
    corner bias as three bf16 pieces whose sum is exact, and everything
    else in the image is 0."""
    packed = _packed(dim, c, nf)
    tiles = fq.decode_tiles(packed, nf=nf, dim=dim, pregathered=pregathered)
    kw = fq.kernel_weights(packed, nf=nf, dtype=BF,
                           f32=("b5", "cb") if pregathered else ("b5",))
    widths, kx, pieces = fq._bf16_plan(c, dim, nf, pregathered)
    assert tiles.image.dtype == BF and tiles.w5.dtype == BF
    assert tiles.b5.dtype == torch.float32
    assert kw["cb"].dtype == (torch.float32 if pregathered else BF)
    mats = _layer_blocks(tiles, widths, kx)
    true = [nf * m for m in (16, 8, 4, 2, 1)]
    pad64 = [-(-w // 64) * 64 for w in true]
    offs = np.cumsum([0] + pad64)
    nk = 2 ** dim
    for i, b in enumerate(mats):
        cols = slice(int(offs[i]), int(offs[i]) + true[i])
        lat = kw["wx0"] if i == 0 else kw[f"wb{i}"][:, pad64[i - 1]:]
        want = torch.zeros_like(b)
        want[:true[i], :c] = lat[:true[i], :c].float()
        want[:true[i], c:c + dim] = kw["rel"][:, cols].t().float()
        if i:
            want[:true[i], kx:kx + true[i - 1]] = \
                kw[f"wb{i}"][:true[i], :true[i - 1]].float()
        corner = b[:true[i], c + dim:c + dim + pieces * nk]
        b = b.clone()
        b[:true[i], c + dim:c + dim + pieces * nk] = 0
        assert torch.equal(b, want), i
        # The corner bias: pieces that are bf16 values summing to it
        # exactly, hi first.
        got = corner.double().reshape(true[i], nk, pieces)
        assert torch.equal(got.sum(-1),
                           kw["cb"][:, cols].t().double()), i
        assert torch.equal(got[..., 0], kw["cb"][:, cols].t().to(
            BF).double()), i
    assert torch.equal(tiles.w5, kw["w5"]) and torch.equal(tiles.b5,
                                                            kw["b5"])


@pytest.mark.parametrize("pregathered", [False, True])
@pytest.mark.parametrize("dim", [1, 3, 4])
def test_schedule_stages_fit_the_ring(dim, pregathered):
    """Every stage is a whole number of k16 blocks and 8-column groups,
    at most one 16 KB ring slot, splits into 4 equal 16-byte multiples
    (a cluster's multicast slices), and the stages cover each layer's
    [W_i, kx + W_{i-1}] once, in order."""
    for c, nf in WIDTHS + [(128, 64), (181, 64)]:
        widths, kx, pieces = fq._bf16_plan(c, dim, nf, pregathered)
        assert kx % 16 == 0 and kx >= c + dim + (pieces << dim)
        seen = {}
        for layer, c0, np_, k0, kn in fq._bf16_schedule(widths, kx):
            nbytes = 2 * np_ * kn
            assert kn % 16 == 0 and np_ % 8 == 0 and nbytes <= 16384
            assert nbytes % (4 * 16) == 0
            key = (layer, c0)
            assert seen.get(key, 0) == k0
            seen[key] = k0 + kn
        for layer, w in enumerate(widths):
            k = kx + (widths[layer - 1] if layer else 0)
            np_ = min(w, 512)
            assert [seen[(layer, c0)] for c0 in range(0, w, np_)] == \
                [k] * (w // np_)


def _emulate(tiles, rows, frac, *, dim, nf, pregathered):
    """The kernel's arithmetic on the image: per pass, per stage, per k16
    block ``acc += A[:, k:k+16] @ B_blk^T`` in f32, A from X then H."""
    rnd = lambda t: t.to(BF).float()
    n = frac.shape[0]
    nk = 2 ** dim
    c = tiles.c
    widths, kx, pieces = fq._bf16_plan(c, dim, nf, pregathered)
    x = torch.zeros(n * nk, kx)
    x[:, :c] = rows.float()
    x[:, c:c + dim] = rnd(frac).repeat_interleave(nk, 0)
    corner = torch.arange(n * nk) % nk
    for j in range(pieces):
        x[torch.arange(n * nk), c + dim + corner * pieces + j] = 1.0
    image = tiles.image.float()
    h, at, acc = None, 0, {}
    outs = [torch.zeros(n * nk, w) for w in widths]
    for layer, c0, np_, k0, kn in fq._bf16_schedule(widths, kx):
        blk = image[at:at + np_ * kn].reshape(kn // 16, np_ // 8, 2, 8, 8)
        at += np_ * kn
        a = acc.setdefault((layer, c0), torch.zeros(n * nk, np_))
        for j in range(kn // 16):
            b = blk[j].permute(0, 2, 1, 3).reshape(np_, 16)
            kk = k0 + 16 * j
            src = x[:, kk:kk + 16] if kk < kx else h[:, kk - kx:kk - kx + 16]
            a += src @ b.t()
            if pregathered and kk + 16 == kx:
                a.copy_(rnd(a))
        k = kx + (widths[layer - 1] if layer else 0)
        if k0 + kn == k:
            v = torch.nn.functional.leaky_relu(a, 0.01)
            outs[layer][:, c0:c0 + np_] = rnd(v) if layer < 4 else v
            if c0 + np_ == widths[layer]:
                h = outs[layer]
    assert at == image.numel()
    w = fq._corner_weights(frac)
    hb = rnd((h[:, :nf].reshape(n, nk, nf) * w[..., None]).sum(1))
    return hb @ tiles.w5.float() + tiles.b5


def _emulated_and_twin(c, nf, dim, pregathered):
    """(the emulation, the bf16 twin of the entry) on 37 points, n not a
    multiple of a 64-row tile."""
    packed = _packed(dim, c, nf, seed=1)
    rng = np.random.RandomState(2)
    nk, n_cells, n = 2 ** dim, 13, 37
    table = torch.from_numpy(rng.randn(n_cells, nk * c).astype(
        np.float32)).to(BF)
    cells = torch.from_numpy(rng.randint(0, n_cells, n).astype(np.int32))
    frac = torch.from_numpy(rng.rand(n, dim).astype(np.float32))
    feats2 = table[cells.long()].reshape(-1, c)
    kw = dict(nf=nf, compute_dtype=BF)
    with torch.no_grad():
        tiles = fq.decode_tiles(packed, nf=nf, dim=dim,
                                pregathered=pregathered)
        if pregathered:
            want = fq.decode_blend_plain(feats2, frac, packed,
                                         n_corners=nk, **kw)
        else:
            want = fq.decode_blend_gather_plain(table, cells, frac, packed,
                                                **kw)
        got = _emulate(tiles, feats2, frac, dim=dim, nf=nf,
                       pregathered=pregathered)
    return got, want


@pytest.mark.parametrize("pregathered", [False, True])
@pytest.mark.parametrize("dim", [3, 4])
@pytest.mark.parametrize("c,nf", [(8, 8), (5, 4)])
def test_tile_schedule_emulated_matches_twins(c, nf, dim, pregathered):
    """The image driven in the kernel's schedule against the bf16 twin of
    its entry (``decode_blend_gather_plain``, or ``decode_blend_plain``
    with its f32 corner bias and rounded skip term) at rtol 1e-5 of
    max |twin|, at test widths (from nf = 16 on, sums in the two orders
    put some h on the other bf16 step; see the flagship test below)."""
    got, want = _emulated_and_twin(c, nf, dim, pregathered)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


# Four bf16 steps of max |twin|: the rule the card holds the kernel to
# (tests/test_torch_cuda.py BF16_DIRECT).
BF16_DIRECT = 4 * 2.0 ** -8


@pytest.mark.parametrize("pregathered", [False, True])
@pytest.mark.parametrize("dim", [3, 4])
def test_tile_schedule_emulated_flagship_widths(dim, pregathered):
    """At C = 64, nf = 64 the emulation sums each pre-activation over
    1,104 products in k16 blocks and the twin in another order, so a few
    h values round to the other bf16 step and move their points by about
    1e-3 of max |twin| (37 points, seed 2): the emulation is held by the
    card's rule, and every point that no flip reaches still matches at
    rtol 1e-5."""
    got, want = _emulated_and_twin(64, 64, dim, pregathered)
    err = (got - want).abs()
    scale = float(want.abs().max())
    assert float(err.max()) <= BF16_DIRECT * scale, float(err.max())
    close = (err <= 1e-5 * (want.abs() + scale)).all(dim=1)
    assert int(close.sum()) >= 0.5 * len(close), int(close.sum())
