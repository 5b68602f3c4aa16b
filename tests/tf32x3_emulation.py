"""The 3xTF32 arithmetic of the f32 decode and jet kernels, emulated on
the CPU in numpy and PyTorch: shared by ``test_torch_decode_split.py``
(``csrc/fused_query.cu``) and ``test_torch_jet_split.py``
(``csrc/fused_jet.cu``).

Each f32 operand x splits into hi = tf32(x) and lo = tf32(x - hi) (round
to nearest, 10 mantissa bits), and a product a b becomes lo_a hi_b +
hi_a lo_b + hi_a hi_b; each k8 step's three products are summed and
added to an f32 accumulator.
"""

import os

import numpy as np
import torch

from space_time_pde_torch.models.nonlinearities import get_activation
from space_time_pde_torch.ops import fused_jet as fj
from space_time_pde_torch.ops import fused_query as fq

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

