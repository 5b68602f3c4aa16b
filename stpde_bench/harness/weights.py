"""The model's weights from the seed, on the device, in a few large
calls: flax's initialisation (kernels lecun-normal, a normal truncated
to two standard deviations and scaled to variance 1 / fan_in; biases 0;
norm scales 1), drawn as one uniform tensor by a ``torch.Generator`` on
the device and turned into the truncated normal by the inverse of its
distribution function."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from stpde_bench.reference.model import Spec

_TRUNC_STD = 0.87962566103423978     # std of the unit normal cut at +-2


def make(specs: List[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    counts = [math.prod(s) for _, s, _, _ in specs]
    std = [math.sqrt(1.0 / fan) / _TRUNC_STD if init == "lecun" else 0.0
           for _, _, init, fan in specs]
    base = [1.0 if init == "ones" else 0.0 for _, _, init, _ in specs]
    kw = dict(dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(sum(counts), generator=gen, **kw)
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    z = math.sqrt(2) * torch.erfinv(2 * (lo + (1 - 2 * lo) * u) - 1)
    n = torch.tensor(counts, device=device)
    flat = (torch.repeat_interleave(torch.tensor(base, **kw), n)
            + torch.repeat_interleave(torch.tensor(std, **kw), n) * z)
    return {name: part.view(shape) for (name, shape, _, _), part in
            zip(specs, flat.split(counts))}
