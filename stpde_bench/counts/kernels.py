"""Operations and bytes of the port's hand-written kernels, from shapes.

The arithmetic of ``chip_smoke.py::bound`` (the original; a later change
may retire it there), with each operation counted once whatever the
kernel does to compute it: a 3xTF32 kernel runs three TF32 products for
each f32 one, and is held here to the one. Per corner row (``rows = n x
2^D``) the decode needs ``(C + D) 31 nf`` multiply-adds for ImNet's skip
inputs and ``170 nf^2`` for its hidden layers; the jet runs the hidden
layers on ``D + 1`` chains (value and D tangents), the skip inputs on
the value only, and blends ``1 + D + D(D+1)/2`` blocks; its backward
needs two products a layer (the weight gradient and the back-propagated
chain) and reads the forward's stored chains and masks. Bytes: each
input read once and each output written once. ``wb``: bytes a value of
the compute type (4 for f32, 2 for bf16).
"""

from __future__ import annotations

from typing import Tuple


def _weights(c, dim, nf, out, wb, corner_bias_bytes):
    k, s = 2 ** dim, 31 * nf
    hidden = 170 * nf * nf
    weights = wb * ((c + dim) * s + hidden + nf * out) \
        + corner_bias_bytes * k * s + 4 * out
    weights32 = 4 * ((c + dim + k) * s + hidden + nf * out + out)
    return weights, weights32


def _head(n, dim, nf, out):
    k = 2 ** dim
    chains = dim + 1
    blocks = 1 + dim + dim * (dim + 1) // 2
    return 2 * n * blocks * (k * chains * nf + nf * out), blocks


def decode_blend_gather(n, c, dim, nf, out, n_cells, wb=4
                        ) -> Tuple[float, float]:
    """(operations, bytes) of one decode of ``n`` points from a latent
    table of ``n_cells`` cell rows (each ``2^D x C`` values)."""
    k, s, hidden = 2 ** dim, 31 * nf, 170 * nf * nf
    rows = n * k
    weights, _ = _weights(c, dim, nf, out, wb, wb)
    flop = 2 * rows * ((c + dim) * s + hidden + nf) + 2 * n * nf * out
    byts = wb * n_cells * k * c + 4 * n + 4 * n * dim + weights \
        + 4 * n * out
    return float(flop), float(byts)


def jet_fwd(n, c, dim, nf, out, wb=4) -> Tuple[float, float]:
    """(operations, bytes) of the jet's forward at ``n`` points."""
    k, s, hidden = 2 ** dim, 31 * nf, 170 * nf * nf
    rows = n * k
    weights, _ = _weights(c, dim, nf, out, wb, 4)
    head, blocks = _head(n, dim, nf, out)
    flop = 2 * rows * ((dim + 1) * hidden + (c + dim) * s) + head
    byts = wb * rows * c + 4 * n * dim + weights + 4 * n * blocks * out
    return float(flop), float(byts)


def jet_bwd(n, c, dim, nf, out, wb=4) -> Tuple[float, float]:
    """(operations, bytes) of the jet's backward at ``n`` points."""
    k, s, hidden = 2 ** dim, 31 * nf, 170 * nf * nf
    rows = n * k
    chains = dim + 1
    weights, weights32 = _weights(c, dim, nf, out, wb, 4)
    head, blocks = _head(n, dim, nf, out)
    flop = 2 * rows * (2 * chains * hidden + 2 * c * s) + 2 * head
    saved = rows * chains * (wb * (s - nf) + 4 * nf) + rows * s
    byts = (wb + 4) * rows * c + 4 * n * dim + weights + weights32 \
        + saved + 4 * n * blocks * out
    return float(flop), float(byts)
