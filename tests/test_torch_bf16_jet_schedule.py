"""The bf16 jet kernels' schedule (``csrc/fused_jet_bf16.cu``), on the CPU.

The kernels run every matrix product through one persistent wgmma
kernel: 64 x 64 bf16 tiles, 64-deep stages accumulated in f32, items of
64 rows x 128 columns (the forward layers and the backward's chain
product: all D + 1 chains of a row block), the split-K weight gradients
over fixed row chunks (``ops/fused_jet.py::bf16_tn_plan``) reduced in a
fixed order, operands zero-filled past their edges. A PyTorch emulation
walks that schedule item by item: the forward's skip product first,
rounded with its coordinate term and corner bias into xs (bf16), then
the hidden product on every chain, the primal's sign masking every
chain, layers 0-3 stored in bf16 and layer 4 in f32; the backward's TN
partials chunk by chunk and their fixed-order sum, the NT products per
item with the mask of the layer below, ragged last items and chunks. It
is held against the bf16 twins (``jet_fwd_plain`` at bf16,
``jet_bwd_bf16_plain``) to 1e-5 of max |twin| at test widths, and at the
flagship widths, where sums in the two orders put some stored chains on
the other bf16 step, by the card's rule, as
``tests/test_torch_decode_bf16_tiles.py`` holds the decode's schedule;
the host-side plan functions are checked on their own.
"""

import numpy as np
import pytest
import torch

from space_time_pde_torch.models import ImNet
from space_time_pde_torch.ops import fused_jet as fj
from space_time_pde_torch.ops import fused_query as fq

BF = torch.bfloat16
T, COLS = fj.BF16_TILE, fj.BF16_TILE_COLS
MULTS = (16, 8, 4, 2, 1)
REL = 1e-5


def rnd(t):
    return t.to(BF).float()


def _staged(a, b):
    """a [M, K] @ b [K, N] as the kernel sums it: 64-deep stages, each
    stage's product added to f32 accumulators in order."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], T):
        acc = acc + a[:, k0:k0 + T] @ b[k0:k0 + T]
    return acc


def _tile(m, rows, cols):
    """The zero-filled operand tile of m at (rows, cols) slices."""
    out = torch.zeros(rows.stop - rows.start, cols.stop - cols.start)
    part = m[rows.start:min(rows.stop, m.shape[0]),
             cols.start:min(cols.stop, m.shape[1])]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def _items(rows, w, row_block=T):
    """The items of a [rows, w] output: (row slice, column slice), the
    column blocks of a row block adjacent, each 64 x 128 (or row_block)."""
    cb = -(-w // COLS)
    for t in range(-(-rows // row_block) * cb):
        r0, n0 = (t // cb) * row_block, (t % cb) * COLS
        yield slice(r0, r0 + row_block), slice(n0, n0 + COLS)


def _fixed_sum(parts):
    """``reduce_kernel``'s order: sum q of 8 adds the chunks z = q mod 8 in
    order, then the sums are added in order."""
    sums = [torch.zeros_like(parts[0]) for _ in range(8)]
    for z, p in enumerate(parts):
        sums[z % 8] = sums[z % 8] + p
    out = sums[0]
    for s in sums[1:]:
        out = out + s
    return out


def _tn(a, b):
    """A [m, ka]^T B [m, nb] by the split-K plan: each chunk's partial,
    item by item (64 MT x 128 outputs), then the fixed-order sum."""
    m, ka = a.shape
    nb = b.shape[1]
    mt, mtiles, ntiles, chunk, chunks = fj.bf16_tn_plan(m, ka, nb)
    parts = []
    for z in range(chunks):
        ks = slice(z * chunk, min(m, (z + 1) * chunk))
        part = torch.zeros(ka, nb)
        for tt in range(mtiles * ntiles):
            i0, n0 = (tt // ntiles) * mt * T, (tt % ntiles) * COLS
            at = _tile(a[ks], slice(0, ks.stop - ks.start),
                       slice(i0, i0 + mt * T))
            bt = _tile(b[ks], slice(0, ks.stop - ks.start),
                       slice(n0, n0 + COLS))
            out = _staged(at.t(), bt)
            part[i0:i0 + mt * T, n0:n0 + COLS] = \
                out[:min(ka, i0 + mt * T) - i0, :min(nb, n0 + COLS) - n0]
        parts.append(part)
    return _fixed_sum(parts)


def _layout(nf):
    widths = [nf * m for m in MULTS]
    return widths, np.cumsum([0] + widths)


def emulate_forward(feats2, frac, packed, *, nf, slope):
    """The forward kernels' schedule -> (jet [N, blocks, O], every layer's
    chains [D+1, R, w] as stored, every layer's mask [R, w])."""
    n, dim = frac.shape
    nk, chains = 2 ** dim, dim + 1
    rows = n * nk
    p = {k: v.float() for k, v in packed.items()}
    feats = feats2.float()
    frac_b = rnd(frac)
    widths, off = _layout(nf)
    xs_all, masks, prev = [], [], None
    for i, w in enumerate(widths):
        sl = slice(int(off[i]), int(off[i]) + w)
        wxf, wxr, cb = p["wx_feat"][:, sl], p["wx_rel"][:, sl], \
            p["corner_bias"][:, sl]
        out = torch.zeros(chains, rows, w)
        mask = torch.zeros(rows, w, dtype=torch.bool)
        for rs, cs in _items(rows, w):
            nr = min(rows, rs.stop) - rs.start
            nc = min(w, cs.stop) - cs.start
            ks = slice(0, feats.shape[1])
            skip = _staged(_tile(feats, rs, ks), _tile(wxf, ks, cs))
            rr = torch.arange(rs.start, rs.start + nr)
            xr = torch.zeros(nr, nc)
            for d in range(dim):
                xr = xr + frac_b[rr // nk, d, None] * wxr[d, cs][None]
            xs = rnd(skip[:nr, :nc] + (xr + cb[rr % nk][:, cs]))
            if i:
                kp = slice(0, prev.shape[-1])
                hid = [_staged(_tile(prev[c], rs, kp),
                               _tile(p[f"wh{i}"], kp, cs))[:nr, :nc]
                       for c in range(chains)]
                pre = hid[0] + xs
            else:
                pre = xs
            m = torch.where(pre >= 0, 1.0, slope)
            out[0, rs, cs][:nr] = m * pre
            for c in range(1, chains):
                inj = wxr[c - 1, cs][None]
                out[c, rs, cs][:nr] = m * (hid[c] + inj if i else inj)
            mask[rs, cs][:nr] = pre >= 0
        prev = rnd(out) if i < 4 else out
        xs_all.append(prev)
        masks.append(mask)
    h = prev[0].reshape(n, nk, nf)
    g = prev[1:].permute(1, 0, 2).reshape(n, nk, dim, nf)
    jet = fj._head(fj._stacked(h, g, frac), p, rnd)
    return jet, xs_all, masks


def emulate_backward(feats2, frac, packed, ybar, chains_x, masks, *, nf,
                     slope):
    """The backward kernels' schedule on the forward's stored chains and
    masks -> (d feats2, {name: gradient}), every one f32."""
    from space_time_pde_torch.ops.jet import multilinear_weight_jet

    n, dim = frac.shape
    nk, chains = 2 ** dim, dim + 1
    rows = n * nk
    p = {k: v.float() for k, v in packed.items()}
    widths, off = _layout(nf)
    feats = rnd(feats2.float())
    w_, dw, d2w = multilinear_weight_jet(frac)
    x4 = chains_x[4]
    h4 = x4[0].reshape(n, nk, nf)
    g4 = x4[1:].permute(1, 0, 2).reshape(n, nk, dim, nf)
    yb = rnd(ybar.float())
    grads = {"w5": torch.einsum("nbj,nbo->jo",
                                rnd(fj._stacked(h4, g4, frac)), yb),
             "b5": ybar[:, :1].float().sum(0)}
    # The head: the blends' transpose in f32, masked by layer 4's mask.
    bars = yb @ p["w5"].t()
    bj = [bars[:, 1 + a, None] for a in range(dim)]
    hbar = w_[..., None] * bars[:, :1]
    for a in range(dim):
        hbar = hbar + dw[..., a, None] * bj[a]
    gbar = [w_[..., None] * bj[a] for a in range(dim)]
    for q, (a, b) in enumerate(fj.tri_pairs(dim)):
        bh = bars[:, 1 + dim + q, None]
        if a != b:
            hbar = hbar + d2w[..., a, b, None] * bh
        gbar[b] = gbar[b] + dw[..., a, None] * bh
        gbar[a] = gbar[a] + dw[..., b, None] * bh
    m4 = torch.where(masks[4], 1.0, slope)
    P = torch.stack([hbar.reshape(rows, nf)]
                    + [g.reshape(rows, nf) for g in gbar]) * m4  # f32
    dfeats = None
    wx_feat = torch.zeros_like(p["wx_feat"])
    wx_rel = torch.zeros_like(p["wx_rel"])
    corner = torch.zeros_like(p["corner_bias"])
    for i in range(4, -1, -1):
        w = widths[i]
        sl = slice(int(off[i]), int(off[i]) + w)
        pb = rnd(P)                                   # the bf16 operand
        if i:
            kp = widths[i - 1]
            grads[f"wh{i}"] = _tn(chains_x[i - 1].reshape(-1, kp),
                                  pb.reshape(-1, w))
        wx_feat[:, sl] = _tn(feats, pb[0])
        # The bias-side sums (jet_common.cuh::bias_grad_kernel).
        prim = P[0].reshape(n, nk, w)
        corner[:, sl] = prim.sum(0)
        wx_rel[:, sl] = rnd(frac).t() @ rnd(prim.sum(1)) + torch.stack(
            [pb[1 + a].sum(0) for a in range(dim)])
        # d feats2 (+)= P_i[primal] Wx_feat[:, sl]^T, 256 rows an item.
        c = feats.shape[1]
        part = torch.zeros(rows, c)
        for rs, cs in _items(rows, c, row_block=4 * T):
            nr = min(rows, rs.stop) - rs.start
            nc = min(c, cs.stop) - cs.start
            ks = slice(0, w)
            part[rs, cs][:nr] = _staged(
                _tile(pb[0], rs, ks),
                _tile(p["wx_feat"][:, sl], slice(cs.start, cs.stop),
                      ks).t())[:nr, :nc]
        dfeats = part if dfeats is None else dfeats + part
        if i:
            # P_{i-1} = (P_i Wh_i^T) * mask_{i-1}, all chains an item.
            kp = widths[i - 1]
            nxt = torch.zeros(chains, rows, kp)
            m = torch.where(masks[i - 1], 1.0, slope)
            for rs, cs in _items(rows, kp):
                nr = min(rows, rs.stop) - rs.start
                nc = min(kp, cs.stop) - cs.start
                ks = slice(0, w)
                bt = _tile(p[f"wh{i}"], slice(cs.start, cs.stop), ks).t()
                for ch in range(chains):
                    nxt[ch, rs, cs][:nr] = _staged(
                        _tile(pb[ch], rs, ks), bt)[:nr, :nc] * m[rs, cs]
            P = nxt
    grads.update(wx_feat=wx_feat, wx_rel=wx_rel, corner_bias=corner)
    return dfeats, grads


def _inputs(dim, c, nf, n, seed=0):
    torch.manual_seed(seed)
    imnet = ImNet(dim=dim, in_features=c, out_features=4, nf=nf)
    with torch.no_grad():
        packed = fq.pack_imnet_params(imnet, dtype=BF)
    rng = np.random.RandomState(seed)
    nk = 2 ** dim
    feats2 = torch.from_numpy(rng.randn(n * nk, c).astype(np.float32)).to(BF)
    frac = rng.rand(n, dim).astype(np.float32)
    frac[:2] = np.array([0.0, 1.0])[:, None]
    frac = torch.from_numpy(frac)
    blocks = 1 + dim + dim * (dim + 1) // 2
    ybar = torch.from_numpy(rng.randn(n, blocks, 4).astype(np.float32))
    return feats2, frac, packed, ybar


def _close(got, want, what):
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    assert torch.isfinite(got).all(), what
    assert err <= REL * scale, (what, err, scale)


# (C, nf, n): test widths with ragged row blocks and chunks (n 2^D rows
# not a multiple of 64; C and the widths below 64 and 128). From nf = 8 on
# the two orders of the sums put some stored h, g or P on the other bf16
# step (see the flagship test).
SHAPES = [(8, 4, 37), (5, 2, 21)]
# Four bf16 steps of max |twin|: the rule the card holds the kernels to
# (tests/test_torch_cuda.py BF16_DIRECT).
BF16_DIRECT = 4 * 2.0 ** -8


@pytest.mark.parametrize("dim", [3, 4])
@pytest.mark.parametrize("c,nf,n", SHAPES)
def test_forward_schedule_emulated_matches_twin(c, nf, n, dim):
    """Item by item, skip product first and xs rounded before the hidden
    product adds: the jet blocks within 1e-5 of max |twin| of
    ``jet_fwd_plain`` at bf16, every mask as the twin's."""
    feats2, frac, packed, _ = _inputs(dim, c, nf, n)
    with torch.no_grad():
        got, _, masks = emulate_forward(feats2, frac, packed, nf=nf,
                                        slope=0.01)
        want, pres = fj.jet_fwd_plain(feats2, frac, packed, nf=nf,
                                      slope=0.01, compute_dtype=BF,
                                      return_pre=True)
    _close(got, want, "blocks")
    for mask, pre in zip(masks, pres):
        assert torch.equal(mask, (pre >= 0).reshape(mask.shape))


@pytest.mark.parametrize("dim", [3, 4])
@pytest.mark.parametrize("c,nf,n", SHAPES)
def test_backward_schedule_emulated_matches_twin(c, nf, n, dim):
    """The split-K partials chunk by chunk with their fixed-order sum, the
    NT products item by item under the mask of the layer below: d feats2
    and every gradient within 1e-5 of max |twin| of
    ``jet_bwd_bf16_plain``."""
    feats2, frac, packed, ybar = _inputs(dim, c, nf, n, seed=1)
    with torch.no_grad():
        _, chains, masks = emulate_forward(feats2, frac, packed, nf=nf,
                                           slope=0.01)
        got_d, got = emulate_backward(feats2, frac, packed, ybar, chains,
                                      masks, nf=nf, slope=0.01)
        want_d, want = fj.jet_bwd_bf16_plain(feats2, frac, packed, ybar,
                                             nf=nf, slope=0.01)
    _close(got_d, want_d, "dfeats2")
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], name)


def _held_by_points(got, want, what):
    """The card's rule on a per-point output, and its median point within
    a quarter bf16 step (2^-10) of max |twin|."""
    err = (got.double() - want.double()).abs().reshape(len(want), -1)
    scale = float(want.double().abs().max())
    assert float(err.max()) <= BF16_DIRECT * scale, (what, float(err.max()))
    assert float(err.max(1).values.median()) <= 2.0 ** -10 * scale, what


@pytest.mark.parametrize("dim", [3, 4])
def test_schedule_emulated_flagship_widths(dim):
    """At C = 64, nf = 64 each pre-activation sums up to 1,024 products in
    64-deep stages and the twin sums them in another order, so some
    stored h, g and P round to the other bf16 step and move what they
    reach by up to about 1e-3 of max |twin| (9 points, seeds 0 and 1; at
    most 0.1% of the masks flip): the emulation is held by the card's rule
    (every block, d feats2 and gradient within four bf16 steps of max
    |twin|), and the per-point outputs' median point within a quarter
    bf16 step."""
    for seed in (0, 1):
        feats2, frac, packed, ybar = _inputs(dim, 64, 64, 9, seed=seed)
        with torch.no_grad():
            got, chains, masks = emulate_forward(feats2, frac, packed,
                                                 nf=64, slope=0.01)
            want, pres = fj.jet_fwd_plain(feats2, frac, packed, nf=64,
                                          slope=0.01, compute_dtype=BF,
                                          return_pre=True)
            got_d, grads = emulate_backward(feats2, frac, packed, ybar,
                                            chains, masks, nf=64,
                                            slope=0.01)
            want_d, wgrads = fj.jet_bwd_bf16_plain(
                feats2, frac, packed, ybar, nf=64, slope=0.01, masks=masks)
        for mask, pre in zip(masks, pres):
            flips = mask != (pre >= 0).reshape(mask.shape)
            assert int(flips.sum()) <= 0.001 * flips.numel()
        _held_by_points(got, want, "blocks")
        _held_by_points(got_d, want_d, "dfeats2")
        for name in wgrads:
            err = float((grads[name] - wgrads[name]).abs().max())
            assert err <= BF16_DIRECT * float(wgrads[name].abs().max()), \
                name


@pytest.mark.parametrize("m,ka,nb", [(262144, 1024, 512), (65536, 64, 1024),
                                     (1184, 128, 64), (296, 16, 8),
                                     (8, 1, 1), (64, 2048, 128)])
def test_tn_plan_chunks_cover_the_rows(m, ka, nb):
    """``bf16_tn_plan``: A tiles an item by ka (1 up to 64 rows, 2 up to
    128, else 4), tiles covering [ka, nb], chunks a multiple of a stage
    (so a stage never reads past its chunk) covering the m rows once,
    the last one ragged, about 4 items an SM."""
    mt, mtiles, ntiles, chunk, chunks = fj.bf16_tn_plan(m, ka, nb)
    assert mt == (1 if ka <= 64 else 2 if ka <= 128 else 4)
    assert mtiles == -(-ka // (64 * mt)) and ntiles == -(-nb // 128)
    assert chunk % 64 == 0 and chunk >= 64
    assert (chunks - 1) * chunk < m <= chunks * chunk
    assert chunks * mtiles * ntiles <= max(4 * 132, mtiles * ntiles)
    if m >= 64 * 4 * 132:
        assert chunks * mtiles * ntiles >= 2 * 132


def test_tn_plan_flagship():
    """The flagship's layer-1 weight gradient (D = 3, 8,192 points: 4R =
    262,144 chain rows, [1024, 512]): 16 tiles of 256 x 128, 33 chunks of
    8,000 rows, 528 items; dWx_feat of layer 0 (R rows, [64, 1024])."""
    assert fj.bf16_tn_plan(262144, 1024, 512) == (4, 4, 4, 8000, 33)
    assert fj.bf16_tn_plan(65536, 64, 1024) == (1, 1, 8, 1024, 64)


@pytest.mark.parametrize("mt,staging,stages,smem", [
    (4, True, 4, 231424), (5, True, 3, 206848), (4, False, 4, 198656),
    (2, False, 6, 198656), (1, False, 6, 149504)])
def test_ring_fits_227_kb(mt, staging, stages, smem):
    """``bf16_ring``: (MT + 2) 8 KB tiles a stage, as many stages as fit
    227 KB with the alignment, the mbarriers and (forward, chain product)
    the 32 KB of staging rows, 3 to 6: the forward's D = 3 ring is 4 x 48
    KB, D = 4 3 x 56 KB."""
    stage, n, total = fj.bf16_ring(mt, staging)
    assert stage == (mt + 2) * 8192
    assert (n, total) == (stages, smem)
    assert total <= 232448 and 3 <= n <= 6


def test_fixed_sum_is_the_reduce_order():
    """The emulated reduction adds each chunk once, in ``reduce_kernel``'s
    order: the same bits on every call, and the float64 sum within f32
    rounding."""
    rng = np.random.RandomState(5)
    parts = [torch.from_numpy(rng.randn(7, 5).astype(np.float32))
             for _ in range(19)]
    a, b = _fixed_sum(parts), _fixed_sum(list(parts))
    assert torch.equal(a, b)
    ref = torch.stack([p.double() for p in parts]).sum(0)
    assert float((a.double() - ref).abs().max()) <= 1e-5
