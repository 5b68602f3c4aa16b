"""Operations of the U-Net encoders, from shapes.

Each convolution is counted as 2 x (output voxels) x (input channels) x
(output channels) x (kernel volume); a transposed stride-2 convolution
of kernel 2 as 2 x (output voxels) x in x out; UNet4d's factorised
convolution as its 3-D spatial part (on every frame) plus its 1-D
temporal part. Norms, activations, padding and the up-sampling's
repeats are left out (under 1% of the operations at the flagship
widths). A training step's backward counts each convolution twice
more (the input's and the weight's gradient), except the input's
gradient of the very first convolution, which nothing needs.
"""

from __future__ import annotations

import math
from typing import List


def _vol(shape) -> int:
    return int(math.prod(shape))


def conv_macs(model: dict, igres) -> List[float]:
    """Multiply-adds of each convolution of one window's forward, in
    order (the first is the input convolution's first factor)."""
    four = model["encoder"] == "unet4d"
    nf, mf = model["unet_nf"], model["unet_mf"]
    levels = int(math.floor(math.log2(min(igres))))
    macs: List[float] = []

    def conv(cin, cout, k, res, stride=1):
        out_res = tuple(-(-r // stride) for r in res)
        if four:
            # spatial on the input's frames, then temporal.
            frames = res[0]
            macs.append(frames * _vol(out_res[1:]) * cin * cout * k ** 3)
            macs.append(_vol(out_res) * cout * cout * k)
        else:
            macs.append(_vol(out_res) * cin * cout * k ** 3)
        return out_res

    def block(cin, cout, res):
        neck = max(cout // 2, 1)
        conv(cin, neck, 1, res)
        conv(neck, neck, 3, res)
        conv(neck, cout, 1, res)
        if cin != cout:
            conv(cin, cout, 1, res)

    res = tuple(igres)
    conv(model["in_channels"], nf, 3, res)
    chs, ress, ch = [], [], nf
    for _ in range(levels):
        block(ch, ch, res)
        chs.append(ch)
        ress.append(res)
        nxt = min(ch * 2, mf)
        res = conv(ch, nxt, 3, res, stride=2)
        ch = nxt
    block(ch, ch, res)
    for i in reversed(range(levels)):
        if four:
            conv(ch, chs[i], 3, ress[i])
        else:
            macs.append(_vol(ress[i]) * ch * chs[i])
        block(2 * chs[i], chs[i], ress[i])
        ch = chs[i]
    conv(ch, model["lat_dims"], 1, ress[0])
    return [float(m) for m in macs]


def forward_flop(model: dict, igres) -> float:
    """Operations of one window's forward."""
    return 2.0 * sum(conv_macs(model, igres))


def train_flop(model: dict, igres) -> float:
    """Operations of one window's forward and backward."""
    macs = conv_macs(model, igres)
    return 2.0 * (3 * sum(macs) - macs[0])
