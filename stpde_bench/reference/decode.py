"""Dense decode of one window, written out: encode the normalised low-res
window, then decode every node of the output lattice (``out_shape``
nodes an axis, endpoints included, in float32 as ``np.linspace`` gives
them) from its cell's corners, in blocks of rows so that it fits."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from stpde_bench.reference import model as M


def lattice(out_shape) -> np.ndarray:
    axes = [np.linspace(0, 1, n, dtype=np.float32) for n in out_shape]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(
        -1, len(out_shape))


@torch.no_grad()
def decode(params: Dict[str, torch.Tensor], model: dict, lres: np.ndarray,
           out_shape, device, block: int = 32768,
           dtype=torch.float32) -> torch.Tensor:
    """``lres [*grid, C]`` -> ``[*out_shape, O]`` on ``device``, in
    ``dtype`` (float64 serves as a witness)."""
    pu, pi = M.split({k: v.to(device=device, dtype=dtype)
                      for k, v in params.items()})
    x = torch.as_tensor(lres, device=device).to(dtype)[None]
    latent = M.Encoder(pu, model, lres.shape[:-1])(x)[0]
    pts = torch.as_tensor(lattice(out_shape), device=device).to(dtype)
    out = torch.cat([M.query(pi, latent, p, model["negative_slope"])
                     for p in pts.split(block)])
    return out.reshape(*out_shape, -1)
