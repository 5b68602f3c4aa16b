"""A from-scratch turb3d run whose encoder multiplies as the TPU's default
matmul precision does: a diagnostic, not a mode of the port.

    python scripts/train_bf16_products.py --recipe turb3d --run_epochs 30 \
        --work /tmp/scratch_bf16 --data_device cpu --init INIT.npz

Runs ``scripts/train_from_scratch.py`` in this process with its own
arguments, after replacing, for this process only, UNet4d's two products
(``models/unet4d.py``: each ``Conv4d``'s spatial ``Conv3d`` and its
temporal product) by the same products on operands rounded to bf16
(round to nearest even), multiplied and summed in f32 and returned in
f32: one MXU pass, which is what an f32 convolution computes on a TPU at
its default precision. The backward's two products take bf16 operands
too: the cotangent is rounded to bf16 where it enters them, the forward's
rounded operands are reused. The temporal bias, the norms, the
activations and the rest of the step stay f32. The JAX package's Pallas
jets (``space_time_pde_tpu/ops/fused_jet.py``) pass no ``precision=`` to
their dots, and what those computed on the TPU is not established, so
the jets stay as the port runs them (3xTF32); so does the ImNet's
decode.

The run's directory is the one ``train_from_scratch.py`` names under
``--work``: use a ``--work`` of its own. The last line is
``train_from_scratch.py``'s JSON, with ``"encoder_products": "bf16"``
added; the curve is reported, not held (the command fails only where the
final parameters are not finite).
"""

import contextlib
import importlib.util
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from space_time_pde_torch.models import unet4d  # noqa: E402
from space_time_pde_torch.models.unet3d import same_pad  # noqa: E402


class _Bf16Operand(torch.autograd.Function):
    """``x`` rounded to bf16, kept in f32; the cotangent passes as is."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g


class _Bf16Cotangent(torch.autograd.Function):
    """The identity; its backward rounds the cotangent to bf16."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def bf16_product(fn, *operands):
    """``fn(*operands)`` on bf16-rounded operands in f32, its backward's
    products on the bf16-rounded cotangent."""
    return _Bf16Cotangent.apply(fn(*[_Bf16Operand.apply(t)
                                     for t in operands]))


def _conv_space(self, h):
    conv = self.spatial
    return bf16_product(lambda x, w: conv._conv_forward(x, w, None),
                        same_pad(h, self.ks, self.stride), conv.weight)


def _conv_time(self, cols):
    w = self.temporal.weight
    h = bf16_product(lambda a, b: a @ b, cols,
                     w.reshape(w.shape[0], -1).t())
    if self.temporal.bias is not None:
        h = h + self.temporal.bias
    return h


@contextlib.contextmanager
def bf16_encoder_products():
    """UNet4d's products on bf16 operands while the context is open."""
    old = unet4d.Conv4d._conv_space, unet4d.Conv4d._conv_time
    unet4d.Conv4d._conv_space, unet4d.Conv4d._conv_time = \
        _conv_space, _conv_time
    try:
        yield
    finally:
        unet4d.Conv4d._conv_space, unet4d.Conv4d._conv_time = old


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if "--policy" in argv and argv[argv.index("--policy") + 1] != "f32":
        raise SystemExit("the diagnostic runs the f32 policy")
    spec = importlib.util.spec_from_file_location(
        "train_from_scratch",
        os.path.join(ROOT, "scripts", "train_from_scratch.py"))
    tfs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tfs)
    with bf16_encoder_products():
        out = tfs.main(argv)
    out["encoder_products"] = "bf16"
    print(json.dumps({"bf16_products": out}), flush=True)
    return out


if __name__ == "__main__":
    # The curve is reported, not held: exit 1 only on non-finite weights.
    sys.exit(0 if main()["train"]["params_finite"] else 1)
