"""The model, written out: parameter list, encoders and the ImNet jet.

MeshfreeFlowNet (arXiv:2005.01463) as the flagship recipes run it: a
U-Net encodes the low-res window to a latent grid at the window's own
resolution (``unet3d`` over (t, z, x), ``unet4d`` over (t, z, y, x) with
each 4-D convolution factorised into a 3-D spatial and a 1-D temporal
one); ImNet decodes each point from its cell's 2^D corner latents and
its coordinates relative to each corner, and the corner outputs are
blended with the multilinear weights.

Layouts follow PyTorch's: a convolution weight is ``[out, in, *k]``, a
transposed convolution's ``[in, out, *k]``, a dense weight ``[out,
in]``. Names follow the flax modules (``conv_in``, ``down_res0.conv1``,
``fc0``...), each prefixed with ``unet.`` or ``imnet.``. Padding follows
XLA's "SAME": a stride-2 convolution at an even size pads one at the
end only. Norms are GroupNorm (eps 1e-6) with the largest group count of
8, 4, 2, 1 that divides the channels; the activation is leaky ReLU.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Spec = Tuple[str, Tuple[int, ...], str, int]   # name, shape, init, fan_in
IMNET_MULTS = (16, 8, 4, 2, 1)


def groups(ch: int) -> int:
    for g in (8, 4, 2, 1):
        if ch % g == 0:
            return g
    return 1


def levels(igres) -> int:
    return int(math.floor(math.log2(min(igres))))


# ------------------------------------------------------------ parameters

def _conv(specs: List[Spec], name, cin, cout, k, dims=3, bias=True):
    shape = (cout, cin) + (k,) * dims
    specs.append((f"{name}.weight", shape, "lecun", cin * k ** dims))
    if bias:
        specs.append((f"{name}.bias", (cout,), "zeros", 0))


def _norm(specs: List[Spec], name, ch):
    specs.append((f"{name}.weight", (ch,), "ones", 0))
    specs.append((f"{name}.bias", (ch,), "zeros", 0))


def _conv4(specs, name, cin, cout, ks, kt, bias=True):
    _conv(specs, f"{name}.spatial", cin, cout, ks, bias=False)
    _conv(specs, f"{name}.temporal", cout, cout, kt, dims=1, bias=bias)


def _block(specs, name, cin, cout, four):
    neck = max(cout // 2, 1)
    if four:
        _conv4(specs, f"{name}.conv1", cin, neck, 1, 1)
        _norm(specs, f"{name}.norm1", neck)
        _conv4(specs, f"{name}.conv2", neck, neck, 3, 3)
        _norm(specs, f"{name}.norm2", neck)
        _conv4(specs, f"{name}.conv3", neck, cout, 1, 1)
        _norm(specs, f"{name}.norm3", cout)
        if cin != cout:
            _conv4(specs, f"{name}.proj", cin, cout, 1, 1, bias=False)
        return
    _conv(specs, f"{name}.conv1", cin, neck, 1)
    _norm(specs, f"{name}.norm1", neck)
    _conv(specs, f"{name}.conv2", neck, neck, 3)
    _norm(specs, f"{name}.norm2", neck)
    _conv(specs, f"{name}.conv3", neck, cout, 1)
    _norm(specs, f"{name}.norm3", cout)
    if cin != cout:
        _conv(specs, f"{name}.proj", cin, cout, 1, bias=False)


def unet_specs(model: dict, igres) -> List[Spec]:
    """The encoder's parameters, in registration order."""
    four = model["encoder"] == "unet4d"
    nf, mf = model["unet_nf"], model["unet_mf"]
    specs: List[Spec] = []
    if four:
        _conv4(specs, "conv_in", model["in_channels"], nf, 3, 3)
    else:
        _conv(specs, "conv_in", model["in_channels"], nf, 3)
    chs, ch = [], nf
    for i in range(levels(igres)):
        _block(specs, f"down_res{i}", ch, ch, four)
        chs.append(ch)
        nxt = min(ch * 2, mf)
        if four:
            _conv4(specs, f"down{i}", ch, nxt, 3, 3)
        else:
            _conv(specs, f"down{i}", ch, nxt, 3)
        ch = nxt
    _block(specs, "bottleneck", ch, ch, four)
    for i in reversed(range(levels(igres))):
        if four:
            _conv4(specs, f"up{i}", ch, chs[i], 3, 3)
        else:
            # ConvTranspose: weight [in, out, 2, 2, 2], fan_in in x 8.
            specs.append((f"up{i}.weight", (ch, chs[i], 2, 2, 2), "lecun",
                          ch * 8))
            specs.append((f"up{i}.bias", (chs[i],), "zeros", 0))
        _block(specs, f"up_res{i}", 2 * chs[i], chs[i], four)
        ch = chs[i]
    if four:
        _conv4(specs, "conv_out", ch, model["lat_dims"], 1, 1)
    else:
        _conv(specs, "conv_out", ch, model["lat_dims"], 1)
    return specs


def imnet_specs(model: dict, dim: int) -> List[Spec]:
    din = dim + model["lat_dims"]
    nf = model["imnet_nf"]
    specs: List[Spec] = []
    prev = 0
    for i, m in enumerate(IMNET_MULTS):
        fan = din + prev
        specs.append((f"fc{i}.weight", (nf * m, fan), "lecun", fan))
        specs.append((f"fc{i}.bias", (nf * m,), "zeros", 0))
        prev = nf * m
    specs.append(("fc5.weight", (model["out_channels"], prev), "lecun",
                  prev))
    specs.append(("fc5.bias", (model["out_channels"],), "zeros", 0))
    return specs


def param_specs(model: dict, igres) -> List[Spec]:
    """Every parameter of the model as ``(name, shape, init, fan_in)``,
    named ``unet.<...>`` / ``imnet.<...>``."""
    return ([("unet." + n, s, i, f) for n, s, i, f in
             unet_specs(model, igres)]
            + [("imnet." + n, s, i, f) for n, s, i, f in
               imnet_specs(model, len(igres))])


# --------------------------------------------------------------- encoders

def _same_pad(x, k, stride, axes):
    """Pad the last ``axes`` axes as XLA's "SAME" does."""
    pads = []
    for n in reversed(x.shape[-axes:]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class Encoder:
    """The U-Net over parameters ``p`` (``unet.``-stripped names):
    ``[B, *grid, C] -> [B, *grid, lat]``."""

    def __init__(self, p: Dict[str, torch.Tensor], model: dict, igres):
        self.p, self.igres = p, tuple(igres)
        self.four = model["encoder"] == "unet4d"
        self.slope = model["negative_slope"]
        self.levels = levels(igres)

    def act(self, x):
        return F.leaky_relu(x, self.slope)

    def norm(self, name, x):
        w = self.p[name + ".weight"]
        return F.group_norm(x, groups(w.shape[0]), w, self.p[name + ".bias"],
                            1e-6)

    def conv(self, name, x, stride=1):
        """A 3-D conv of ``[B, C, *3 axes]`` (``unet3d``) or a factorised
        4-D conv of ``[B, C, T, Z, Y, X]`` (``unet4d``), "SAME"."""
        if not self.four:
            w = self.p[name + ".weight"]
            k = w.shape[-1]
            return F.conv3d(_same_pad(x, k, stride, 3), w,
                            self.p.get(name + ".bias"), stride)
        ws = self.p[name + ".spatial.weight"]
        wt = self.p[name + ".temporal.weight"]
        b, c, t = x.shape[:3]
        h = x.transpose(1, 2).reshape(b * t, c, *x.shape[3:])
        h = F.conv3d(_same_pad(h, ws.shape[-1], stride, 3), ws, None, stride)
        f, z, y, xx = h.shape[1:]
        h = h.reshape(b, t, f, z, y, xx).permute(0, 3, 4, 5, 2, 1)
        h = h.reshape(b * z * y * xx, f, t)
        h = F.conv1d(_same_pad(h, wt.shape[-1], stride, 1), wt,
                     self.p.get(name + ".temporal.bias"), stride)
        t2 = h.shape[-1]
        return h.reshape(b, z, y, xx, f, t2).permute(0, 4, 5, 1, 2, 3)

    def block(self, name, x):
        h = self.act(self.norm(f"{name}.norm1", self.conv(f"{name}.conv1",
                                                          x)))
        h = self.act(self.norm(f"{name}.norm2", self.conv(f"{name}.conv2",
                                                          h)))
        h = self.norm(f"{name}.norm3", self.conv(f"{name}.conv3", h))
        key = f"{name}.proj.weight" if not self.four else \
            f"{name}.proj.spatial.weight"
        if key in self.p:
            x = self.conv(f"{name}.proj", x)
        return self.act(h + x)

    def up(self, i, h):
        if self.four:
            for ax in range(2, 6):
                h = h.repeat_interleave(2, dim=ax)
            return self.conv(f"up{i}", h)
        return F.conv_transpose3d(h, self.p[f"up{i}.weight"],
                                  self.p[f"up{i}.bias"], stride=2)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        perm = (0, x.ndim - 1) + tuple(range(1, x.ndim - 1))
        h = self.act(self.conv("conv_in", x.permute(*perm)))
        skips = []
        for i in range(self.levels):
            h = self.block(f"down_res{i}", h)
            skips.append(h)
            h = self.act(self.conv(f"down{i}", h, stride=2))
        h = self.block("bottleneck", h)
        for i in reversed(range(self.levels)):
            h = self.act(self.up(i, h))
            h = self.block(f"up_res{i}", torch.cat([h, skips[i]], 1))
        out = self.conv("conv_out", h)
        return out.permute(0, *range(2, out.ndim), 1)


# ------------------------------------------------------------------ ImNet

def corners(dim: int, device) -> torch.Tensor:
    """``[2^D, D]`` corner offsets in {0, 1}, the last axis fastest."""
    idx = torch.arange(2 ** dim, device=device)
    bits = [(idx >> (dim - 1 - a)) & 1 for a in range(dim)]
    return torch.stack(bits, -1)


def locate(pts: torch.Tensor, grid):
    """Points in [0, 1]^D -> (cell ``[..., D]`` int64 in [0, n - 2],
    frac in [0, 1], d frac / d p): the clip of the domain, the floor and
    the clip of the last cell, in that order."""
    n = torch.tensor(grid, dtype=pts.dtype, device=pts.device)
    s = pts * (n - 1.0)
    inside = (s > 0) & (s < n - 1.0)
    on_face = (s == 0) | (s == n - 1.0)
    s = torch.minimum(torch.maximum(s, torch.zeros_like(s)), n - 1.0)
    cell = torch.minimum(torch.floor(s), n - 2.0).clamp(min=0.0)
    scale = (n - 1.0) * torch.where(inside, 1.0,
                                    torch.where(on_face, 0.5, 0.0))
    return cell.long(), s - cell, scale.to(pts.dtype)


def gather_corners(latent: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """latent ``[*grid, C]``, cell ``[N, D]`` -> ``[N, 2^D, C]``."""
    grid = latent.shape[:-1]
    dim = len(grid)
    idx = cell[:, None, :] + corners(dim, cell.device)[None]
    flat = torch.zeros(idx.shape[:-1], dtype=torch.long, device=idx.device)
    for a in range(dim):
        flat = flat * grid[a] + idx[..., a]
    return latent.reshape(-1, latent.shape[-1])[flat]


def imnet(p: Dict[str, torch.Tensor], x: torch.Tensor, slope: float,
          tangents: int = 0):
    """ImNet on rows ``x = [rel (D), feats]``: ``(value [R, O], J [R, O,
    tangents])``, the second the derivatives by the first ``tangents``
    inputs, carried through each layer beside the value (ImNet is
    piecewise linear, so its second derivatives are zero)."""
    h, dh = None, None
    for i in range(len(IMNET_MULTS)):
        w, b = p[f"fc{i}.weight"], p[f"fc{i}.bias"]
        if h is None:
            z = x @ w.t() + b
            dz = (w[:, :tangents].t().unsqueeze(0).expand(x.shape[0], -1, -1)
                  if tangents else None)                    # [R, T, W]
        else:
            wh, wx = w[:, :h.shape[-1]], w[:, h.shape[-1]:]
            z = h @ wh.t() + x @ wx.t() + b
            dz = (dh @ wh.t() + wx[:, :tangents].t().unsqueeze(0)
                  if tangents else None)
        slope_of = torch.where(z > 0, 1.0, slope).to(z.dtype)
        h = z * slope_of
        dh = dz * slope_of[:, None, :] if tangents else None
    w5, b5 = p["fc5.weight"], p["fc5.bias"]
    value = h @ w5.t() + b5
    jac = (dh @ w5.t()).transpose(1, 2) if tangents else None
    return value, jac


def weight_jet(frac: torch.Tensor):
    """Multilinear weights of the corners and their first and second
    derivatives by frac: ``w [N, K]``, ``dw [N, K, D]``, ``d2w [N, K, D,
    D]`` (zero on the diagonal)."""
    n, dim = frac.shape
    off = corners(dim, frac.device).to(frac.dtype)          # [K, D]
    phi = off * frac[:, None, :] + (1 - off) * (1 - frac[:, None, :])
    sign = 2 * off - 1                                      # [K, D]

    def prod_without(skip):
        out = torch.ones(phi.shape[:2], dtype=frac.dtype, device=frac.device)
        for a in range(dim):
            if a not in skip:
                out = out * phi[..., a]
        return out

    w = prod_without(())
    dw = torch.stack([prod_without((a,)) * sign[:, a] for a in range(dim)],
                     -1)
    rows = []
    for a in range(dim):
        rows.append(torch.stack([
            torch.zeros_like(w) if a == b else
            prod_without((a, b)) * sign[:, a] * sign[:, b]
            for b in range(dim)], -1))
    return w, dw, torch.stack(rows, -2)


def query(p_imnet, latent: torch.Tensor, pts: torch.Tensor, slope: float,
          jet: bool = False):
    """One grid's latent ``[*grid, C]`` at points ``[N, D]``: the blended
    value ``[N, O]``, and with ``jet`` its Jacobian ``[N, O, D]`` and
    Hessian ``[N, O, D, D]`` by the points' coordinates."""
    grid = tuple(latent.shape[:-1])
    dim = len(grid)
    cell, frac, scale = locate(pts, grid)
    feats = gather_corners(latent, cell)                    # [N, K, C]
    k = feats.shape[1]
    rel = frac[:, None, :] - corners(dim, pts.device).to(frac.dtype)[None]
    rows = torch.cat([rel, feats], -1).reshape(-1, dim + feats.shape[-1])
    value, jac = imnet(p_imnet, rows, slope, dim if jet else 0)
    value = value.reshape(-1, k, value.shape[-1])
    w, dw, d2w = weight_jet(frac)
    pred = torch.einsum("nko,nk->no", value, w)
    if not jet:
        return pred
    jac = jac.reshape(-1, k, *jac.shape[1:])                # [N, K, O, D]
    jf = (torch.einsum("nko,nka->noa", value, dw)
          + torch.einsum("nkoa,nk->noa", jac, w))
    hf = (torch.einsum("nko,nkab->noab", value, d2w)
          + torch.einsum("nkob,nka->noab", jac, dw)
          + torch.einsum("nkoa,nkb->noab", jac, dw))
    return (pred, jf * scale[:, None, :],
            hf * scale[:, None, :, None] * scale[:, None, None, :])


def split(params: Dict[str, torch.Tensor]):
    """``(unet params, imnet params)`` with the prefixes stripped."""
    unet = {k[5:]: v for k, v in params.items() if k.startswith("unet.")}
    imn = {k[6:]: v for k, v in params.items() if k.startswith("imnet.")}
    return unet, imn
