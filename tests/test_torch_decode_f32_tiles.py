"""The f32 decode kernel's host-side weight image and schedule, on the CPU.

``ops/fused_query.py::decode_tiles(compute_dtype=float32)`` lays every
layer's weights out as ``csrc/fused_query.cu`` reads them: segment after
segment of ``_f32_schedule``, each k8 step's TF32 hi plane then lo plane
in wgmma's K-major, no-swizzle shared-memory image of B. Here the image is
read back and held against ``kernel_weights`` (the f32 layout of the
earlier kernel): each weight's hi is its TF32 rounding and lo the TF32
rounding of what is left, so hi + lo is the weight within the lo plane's
rounding (2^-22 of it), the Wh_i rows of each 8-row block sit in the
kernel's permuted order, ``wx_rel`` and ``corner_bias`` follow the
segments in f32 as they are, and everything else is 0. The schedule covers
each layer once in the kernel's order, in ring slots the cluster's
multicast can split, and the kernel's arithmetic driven over the image
(``_tile_chain`` of tests/test_torch_decode_split.py) matches the f32
twin at test widths.
"""

import numpy as np
import pytest
import torch

from space_time_pde_torch.models import ImNet
from space_time_pde_torch.ops import fused_query as fq
from test_torch_decode_split import _tile_chain
from tf32x3_emulation import _mm_tf32x3, _tf32

F32 = torch.float32


def _slot_bytes(widths):
    """The kernel's ring slot: one k8 step of layer 1's columns, hi and lo
    (slot_bytes in csrc/fused_query.cu); a cluster's 2 CTAs each copy
    half of a slot's bytes, a multiple of 16."""
    return 8 * widths[1] * 8


def _packed(dim, c, nf, seed=0):
    torch.manual_seed(seed)
    imnet = ImNet(dim=dim, in_features=c, out_features=4, nf=nf)
    with torch.no_grad():
        return fq.pack_imnet_params(imnet)


def _read_back(image, widths, kx, dim):
    """Each layer's hi and lo ``[W_i, kx + W_{i-1}]`` read back from the
    image, and the rel ``[D, S]`` and cb ``[2^D, S]`` after them."""
    hi = [torch.zeros(w, kx + (widths[i - 1] if i else 0))
          for i, w in enumerate(widths)]
    lo = [torch.zeros_like(m) for m in hi]
    at = 0
    for layer, c0, np_, k0, kn in fq._f32_schedule(widths, kx):
        blk = image[at:at + 2 * np_ * kn].reshape(kn // 8, 2, np_ // 8, 2, 8,
                                                   4)
        planes = blk.permute(1, 2, 4, 0, 3, 5).reshape(2, np_, kn)
        hi[layer][c0:c0 + np_, k0:k0 + kn] = planes[0]
        lo[layer][c0:c0 + np_, k0:k0 + kn] = planes[1]
        at += 2 * np_ * kn
    s = sum(widths)
    rel = image[at:at + dim * s].reshape(dim, s)
    cb = image[at + dim * s:].reshape(2 ** dim, s)
    assert at + (dim + 2 ** dim) * s == image.numel()
    return hi, lo, rel, cb


def _unpermuted(m, kx):
    """The h columns of a layer matrix back in their real order."""
    out = m.clone()
    out[:, kx + fq._f32_h_order(m.shape[1] - kx)] = m[:, kx:]
    return out


@pytest.mark.parametrize("dim", [2, 3, 4])
@pytest.mark.parametrize("c", [5, 33, 64])
@pytest.mark.parametrize("nf", [2, 3, 24, 64])
def test_f32_tile_image_round_trips_to_kernel_weights(nf, c, dim):
    """Every weight of ``kernel_weights`` sits where the kernel reads it as
    hi = tf32(w) and lo = tf32(w - hi), hi + lo within 2^-22 |w| of it,
    ``rel`` and ``cb`` exactly; the rest of the image is 0."""
    packed = _packed(dim, c, nf)
    tiles = fq.decode_tiles(packed, nf=nf, dim=dim, compute_dtype=F32)
    kw = fq.kernel_weights(packed, nf=nf)
    widths, kx = fq._f32_plan(c, nf)
    assert tiles.image.dtype == F32 and tiles.compute_dtype == F32
    assert torch.equal(tiles.w5, packed["w5"])
    assert torch.equal(tiles.b5, packed["b5"])
    assert kx % 8 == 0 and kx >= c
    hi, lo, rel, cb = _read_back(tiles.image, widths, kx, dim)
    true = [nf * m for m in (16, 8, 4, 2, 1)]
    pad64 = [-(-w // 64) * 64 for w in true]
    offs = np.cumsum([0] + pad64)
    img_offs = np.cumsum([0] + widths)
    want_rel, want_cb = torch.zeros_like(rel), torch.zeros_like(cb)
    for i in range(5):
        cols = slice(int(offs[i]), int(offs[i]) + true[i])
        icols = slice(int(img_offs[i]), int(img_offs[i]) + true[i])
        want_rel[:, icols] = kw["rel"][:, cols]
        want_cb[:, icols] = kw["cb"][:, cols]
        lat = kw["wx0"] if i == 0 else kw[f"wb{i}"][pad64[i - 1]:]
        want = torch.zeros_like(hi[i])
        want[:true[i], :c] = lat[:c, :true[i]].t()
        if i:
            want[:true[i], kx:kx + true[i - 1]] = \
                kw[f"wb{i}"][:true[i - 1], :true[i]].t()
        h, l = _unpermuted(hi[i], kx), _unpermuted(lo[i], kx)
        assert torch.equal(h, torch.from_numpy(_tf32(want.numpy()))), i
        assert torch.equal(l, torch.from_numpy(_tf32((want - h).numpy()))), i
        err = ((h.double() + l.double()) - want.double()).abs()
        assert bool((err <= 2.0 ** -22 * want.double().abs()).all()), i
    assert torch.equal(rel, want_rel) and torch.equal(cb, want_cb)


def _macs(widths, kx):
    """Multiply-adds a corner row of a layer stack [W_i, kx + W_{i-1}]."""
    return sum(w * (kx + (widths[i - 1] if i else 0))
               for i, w in enumerate(widths))


@pytest.mark.parametrize("nf,base", [(1, 16), (8, 16), (16, 16), (17, 32),
                                     (24, 32), (32, 32), (33, 64), (48, 64),
                                     (64, 64)])
def test_f32_widths_follow_nf(nf, base):
    """The f32 kernel runs nf at the widths of the smallest of 16, 32 and
    64 that holds it. At nf = 16, 32 and 64 (the repo's configurations)
    that is no more multiply-adds a corner row than the earlier mma.sync
    kernel's layout (``kernel_weights``: widths padded to 64, the latents
    to 32) at any C; nf between them pays for the next power of two. nf >
    64 is refused."""
    for c in (5, 16, 32, 64, 136):
        widths, kx = fq._f32_plan(c, nf)
        assert widths == [base * m for m in (16, 8, 4, 2, 1)] and kx >= c
        old = [-(-nf * m // 64) * 64 for m in (16, 8, 4, 2, 1)]
        if nf == base:
            assert _macs(widths, kx) <= _macs(old, -(-c // 32) * 32), c
    packed = _packed(3, 8, nf)
    tiles = fq.decode_tiles(packed, nf=nf, dim=3, compute_dtype=F32)
    widths, kx = fq._f32_plan(8, nf)
    assert tiles.image.numel() == 2 * _macs(widths, kx) + 11 * 31 * base
    with pytest.raises(ValueError, match="nf <= 64"):
        fq._f32_plan(8, 65)


@pytest.mark.parametrize("dim", [1, 3, 4])
def test_f32_schedule_covers_each_layer_in_ring_slots(dim):
    """The segments cover each layer's ``[W_i, kx + W_{i-1}]`` once: layer
    0 in 64-row chunks over X, each later layer's K in order (X, then h;
    layer 1's h chunk by chunk, each after the next layer-0 chunk); every
    K span a whole number of k8 steps, and every slot the kernel
    cuts from a segment at most a ring slot, in two 16-byte multiples."""
    for c, nf in [(64, 64), (8, 8), (5, 4), (125, 64), (3, 16), (32, 32),
                  (16, 17)]:
        widths, kx = fq._f32_plan(c, nf)
        assert all(w >= 16 and w & (w - 1) == 0 for w in widths)
        slot = _slot_bytes(widths)
        seen = {}
        order = []
        for layer, c0, np_, k0, kn in fq._f32_schedule(widths, kx):
            assert kn % 8 == 0 and np_ % 16 == 0
            assert np_ == (64 if layer == 0 else widths[layer])
            rows = slot // (8 * np_)
            assert rows % 8 == 0
            for s0 in range(0, kn, rows):
                nbytes = 8 * np_ * min(rows, kn - s0)
                assert nbytes <= slot and nbytes % (2 * 16) == 0
            key = (layer, c0)
            assert seen.get(key, 0) == k0
            seen[key] = k0 + kn
            order.append((layer, c0, k0))
        for layer, w in enumerate(widths):
            k = kx + (widths[layer - 1] if layer else 0)
            starts = range(0, w, 64) if layer == 0 else [0]
            assert [seen[(layer, c0)] for c0 in starts] == [k] * len(starts)
        # Chunk j + 1 of h_0 is consumed before layer 1's rows of chunk j.
        for j in range(widths[0] // 64 - 1):
            assert order.index((0, 64 * (j + 1), 0)) < \
                order.index((1, 0, kx + 64 * j))


@pytest.mark.parametrize("dim", [2, 3, 4])
@pytest.mark.parametrize("c,nf,activation", [(8, 8, "leaky_relu"),
                                             (5, 4, "sigmoid"),
                                             (33, 3, "softplus")])
def test_f32_tile_chain_matches_twin(c, nf, dim, activation):
    """The kernel's arithmetic over its image (3xTF32 products, each k8
    step's promoted, on an accumulator started at the f32 coordinate term
    and corner bias) against the f32 twin at the card's kernel-vs-twin
    tolerance
    (rtol = atol = 1e-4), activations that are not 0 at 0 included (the
    padding must stay inert)."""
    torch.manual_seed(3)
    imnet = ImNet(dim=dim, in_features=c, out_features=4, nf=nf,
                  activation=activation)
    rng = np.random.RandomState(4)
    n = 37
    feats2 = torch.from_numpy(rng.randn(n * 2 ** dim, c).astype(np.float32))
    frac = torch.from_numpy(rng.rand(n, dim).astype(np.float32))
    with torch.no_grad():
        packed = fq.pack_imnet_params(imnet)
        want = fq.decode_blend_plain(feats2, frac, packed, nf=nf,
                                     n_corners=2 ** dim,
                                     activation=activation)
        got = _tile_chain(
            packed, feats2, frac, nf=nf, activation=activation,
            matmul=lambda a, b, init: _mm_tf32x3(
                a, b, round_b_lo=True, promoted=True, init=init))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_f32_tiles_serve_both_entries_and_refuse_others():
    """One f32 image serves the gather and the pre-gathered entry (same
    math), and the CPU wrappers run the plain twins whatever ``tiles``
    says; the bf16 image is another."""
    packed = _packed(3, 8, 4)
    f32 = fq.decode_tiles(packed, nf=4, dim=3, compute_dtype=F32)
    pre = fq.decode_tiles(packed, nf=4, dim=3, pregathered=True,
                          compute_dtype=F32)
    assert torch.equal(f32.image, pre.image)
    bf16 = fq.decode_tiles(packed, nf=4, dim=3)
    assert bf16.compute_dtype == torch.bfloat16
    assert bf16.image.dtype == torch.bfloat16
    assert f32.image.numel() != bf16.image.numel()
