"""The f32 jet kernels' host-side plans and weight image, on the CPU.

``csrc/fused_jet.cu`` runs every product of both f32 jets on ``wgmma`` in
3xTF32: its B operands that are weights (the forward's ``Wx_feat[:,
sl_i]^T`` and ``Wh_i^T``, the backward's ``Wh_i`` and ``Wx_feat[:,
sl_i]``) come from one image that ``stpde_jet_fwd`` splits on the card
(``weight_image_kernel``) into its workspace, in wgmma's K-major,
no-swizzle shared-memory order, hi plane then lo plane per k8 step.
``ops/fused_jet.py::f32_weight_image`` builds the same image on the host;
here it is read back through the kernel's own index arithmetic (written
out again below, as the kernel decodes a pair index) and held against the
weights: hi = tf32(w), lo = tf32(w - hi) (hi + lo within 2^-22 |w| of w),
zero past each matrix. The ring and split-K plans that the kernel
launches with (``f32_ring``, ``f32_tn_plan``) fit in 227 KB for every
width the wrapper accepts, refuse a plan of fewer than 2 ring stages, and
cover every row. The card test ``test_f32_jet_image_and_plans_match_
host_mirrors`` holds the device image and plans to these mirrors bit for
bit.
"""

import numpy as np
import pytest
import torch

from space_time_pde_torch.models import ImNet
from space_time_pde_torch.ops import fused_jet as fj
from space_time_pde_torch.ops import fused_query as fq

SMEM = 232448                       # 227 KB, a CTA's most on an H100


def _packed(dim, c, nf, seed=0):
    torch.manual_seed(seed)
    imnet = ImNet(dim=dim, in_features=c, out_features=4, nf=nf)
    with torch.no_grad():
        return fq.pack_imnet_params(imnet)


def _tf32(x):
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _decode(n, k, kn):
    """weight_image_kernel's decode of a segment's pair indices: (n, k,
    hi position, lo position) of every hi / lo pair, positions within the
    segment."""
    nkt = -(-k // 32)
    pairs = -(-n // (2 * kn)) * nkt * 64 * kn
    e = np.arange(pairs)
    step = 8 * kn
    pidx = e % step
    rest = e // step
    s, rest = rest % 4, rest // 4
    q, rest = rest % 2, rest // 2
    kt, cb = rest % nkt, rest // nkt
    grp, h, r, q4 = pidx >> 6, (pidx >> 5) & 1, (pidx >> 2) & 7, pidx & 3
    p = 4 * h + q4
    nn = cb * 2 * kn + q * kn + 8 * grp + r
    kk = 32 * kt + np.where(p < 4, 8 * p + 2 * s, 8 * (p - 4) + 2 * s + 1)
    hi = 2 * (e - pidx) + pidx
    return nn, kk, hi, hi + step


def _expected(packed, nf):
    """Each segment's B [n, k] from the packed weights."""
    wxf = packed["wx_feat"].double().numpy()
    bounds = np.cumsum([0] + [nf * m for m in fq._MULTS])
    out = {}
    for i in range(5):
        xf = wxf[:, bounds[i]:bounds[i + 1]]
        wh = packed[f"wh{i}"].double().numpy() if i else None
        out[(i, "fwd_skip")] = xf.T
        out[(i, "bwd_feats")] = xf
        if i:
            out[(i, "fwd_hidden")] = wh.T
            out[(i, "bwd_hidden")] = wh
    return out


@pytest.mark.parametrize("dim", [3, 4])
@pytest.mark.parametrize("c", [4, 5, 64])
@pytest.mark.parametrize("nf", [2, 3, 16, 64])
def test_f32_weight_image_reads_back_to_the_weights(nf, c, dim):
    """Every weight sits where the kernel reads it, as hi = tf32(w) and lo
    = tf32(w - hi) with hi + lo within 2^-22 |w| of w; every other value
    of the image is 0; the image has f32_image_layout's size."""
    packed = _packed(dim, c, nf)
    image = fj.f32_weight_image(packed, nf=nf, dim=dim).numpy()
    _, floats = fj.f32_image_layout(1, c, dim, nf)
    assert image.shape == (floats,)
    want = _expected(packed, nf)
    at, seen = 0, np.zeros(floats, bool)
    for layer, kind, n, k, kn in fj._f32_segments(c, dim, nf):
        b = want[(layer, kind)]
        assert b.shape == (n, k), (layer, kind)
        nn, kk, hi_at, lo_at = _decode(n, k, kn)
        inside = (nn < n) & (kk < k)
        w32 = np.zeros(nn.shape, np.float32)
        w32[inside] = b[nn[inside], kk[inside]]
        hi, lo = image[at + hi_at], image[at + lo_at]
        np.testing.assert_array_equal(hi, _tf32(w32))
        np.testing.assert_array_equal(lo, _tf32(w32 - _tf32(w32)))
        err = np.abs(hi.astype(np.float64) + lo - w32)
        assert (err <= 2.0 ** -22 * np.abs(w32)).all(), (layer, kind)
        assert not (hi[~inside].any() or lo[~inside].any())
        seen[at + hi_at] = seen[at + lo_at] = True
        at += 2 * len(nn)
    assert at == floats and seen.all()


@pytest.mark.parametrize("dim", [3, 4])
@pytest.mark.parametrize("n,c,nf", [(1, 4, 1), (37, 5, 3), (8192, 64, 64),
                                    (4096, 64, 64)])
def test_f32_image_follows_the_masks(n, c, nf, dim):
    """The image starts 128-byte aligned after the chains and the masks
    (ops/fused_jet.py::workspace_masks reads the masks where they were),
    and every segment is a whole number of 16-byte aligned stage blocks
    (one bulk copy each)."""
    rows, s = n * 2 ** dim, 31 * nf
    off, floats = fj.f32_image_layout(n, c, dim, nf)
    end = 4 * rows * (dim + 1) * s + rows * s
    assert off % 128 == 0 and end <= off < end + 128
    for *_, nn, k, kn in fj._f32_segments(c, dim, nf):
        block = 2 * kn * fj.F32_DEPTH * 8          # both consumers, bytes
        assert block % 16 == 0
        assert 4 * fj._f32_segment_floats(nn, k, kn) % block == 0


def _launch_plans(c, dim, nf):
    """(MT, kn, staging) of every product launch of both f32 jets at these
    widths (run_forward / run_backward)."""
    chains, kc = dim + 1, fj.f32_chain_cols(dim)
    widths = [nf * m for m in fq._MULTS]
    out = [(chains, kc, True)]                   # forward layers, chain NT
    out.append((4, fj.F32_FEAT_COLS, False))     # d feats
    for i, w in enumerate(widths):
        for ka in ([widths[i - 1]] if i else []) + [c]:
            mt = fj.f32_tn_plan(1000, ka, w)[0]
            out.append((mt, fj.F32_TN_COLS, False))
    return out


@pytest.mark.parametrize("dim", [3, 4])
@pytest.mark.parametrize("c", [1, 4, 64, 500])
@pytest.mark.parametrize("nf", [1, 2, 3, 16, 64, 1024])
def test_f32_ring_fits_every_plan(nf, c, dim):
    """Every launch's ring has 2 to 6 stages and fits in 227 KB: the chain
    problems (3 stages of MT 8 KB A tiles + 2 kn x 256 B of B + staging),
    d feats and the split-K products."""
    for mt, kn, staging in _launch_plans(c, dim, nf):
        stage, stages, smem = fj.f32_ring(mt, kn, staging)
        assert stage == mt * 8192 + 2 * kn * 256
        assert 2 <= stages <= 6 and smem <= SMEM, (mt, kn, staging)
        assert smem + stage > SMEM or stages == 6


@pytest.mark.parametrize("mt,kn,staging,stages,smem", [
    (4, 64, True, 3, 231424), (5, 32, True, 3, 190464),
    (4, 32, False, 4, 198656), (4, 64, False, 3, 198656),
    (2, 64, False, 4, 198656), (1, 64, False, 5, 206848)])
def test_f32_ring_flagship_plans(mt, kn, staging, stages, smem):
    """The plans of csrc/fused_jet.cu's source note."""
    assert fj.f32_ring(mt, kn, staging)[1:] == (stages, smem)


@pytest.mark.parametrize("mt,kn,staging", [(12, 64, True), (26, 32, False),
                                           (4, 256, True)])
def test_f32_ring_refuses_fewer_than_two_stages(mt, kn, staging):
    """A stage that fits once in 227 KB gives 0 stages: the launch refuses
    such a plan (cudaErrorInvalidValue) instead of running without a
    ring."""
    stage, stages, _ = fj.f32_ring(mt, kn, staging)
    room = SMEM - 2048 - (8 * 16 * 4 * kn if staging else 0)
    assert room // stage < 2 and stages == 0


@pytest.mark.parametrize("m,ka,nb", [(262144, 1024, 512), (65536, 64, 1024),
                                     (327680, 128, 64), (8, 16, 8),
                                     (296, 3, 2), (1184, 64, 1024),
                                     (8192, 1024, 512)])
def test_f32_tn_plan_chunks_cover_the_rows(m, ka, nb):
    """Chunks are whole stages (32 rows), cover the m rows once, and the
    items (chunks x tiles) about fill four waves of 132 SMs where the
    rows allow."""
    mt, mtiles, ntiles, chunk, chunks = fj.f32_tn_plan(m, ka, nb)
    assert mt in (1, 2, 4) and mtiles * mt * 64 >= ka > (mtiles - 1) * mt * 64
    assert ntiles * 128 >= nb > (ntiles - 1) * 128
    assert chunk % 32 == 0 and (chunks - 1) * chunk < m <= chunks * chunk
    assert chunks * mtiles * ntiles <= 4 * 132 or chunk == 32


def test_f32_step_columns_are_a_permutation_of_each_stage():
    """The k8 steps of a stage take each of its 32 K columns once; a
    thread's 8 values of a step row sit in two 16-byte chunks 2t and 2t +
    1 (load_rows)."""
    cols = fj.F32_STEP_COLS
    assert sorted(cols) == list(range(32))
    for s in range(4):
        for t in range(4):
            assert cols[8 * s + t] // 4 == 2 * t + (s >= 2)
            assert cols[8 * s + t + 4] == cols[8 * s + t] + 1
