"""Training engine: models, initial state, loss and step functions.

Counterpart of ``space_time_pde_tpu/train/trainer.py``. Encode the
low-res crop with UNet3d (UNet4d for a 4-D crop), take the derivative
jet of the local implicit grid at the sampled points, regression loss (l1 / l2 / huber) of the
jet's value against the point ground truth, PDE residual loss from its
Jacobian and Hessian, total = reg + alpha_pde * pde, and the optimizer
of ``train/optim.py``.

``pde_derivs`` picks how the derivatives are taken, as in the JAX
package: ``jet`` runs ``ops/fused_jet.py`` when ``fused_query`` is set
(the CUDA jet kernels on a card; their plain twins on the CPU),
``jet_jnp`` the plain analytic jet of ``ops/jet.py``, and ``tower``
nested ``torch.func.jvp`` towers through the query. The jets need a
piecewise-linear activation and derivatives of order <= 2; otherwise
the towers run.

PyTorch runs eagerly, so there is no jit: a step is ``backward`` and an
in-place optimizer update, and ``make_multi_step`` is a loop (the JAX
package's ``lax.scan`` was a dispatch workaround). With
``norm="batch"`` the loss runs the encoder in train mode (batch
statistics; the running averages move in the forward, so a step that
the optimizer skips keeps them, as JAX keeps ``batch_stats`` on a
skipped step) and the eval function in eval mode (running statistics).

The bf16 compute policy (``use_bf16``, ``models/policy.py``): both
families' encoders and the ImNet compute in bf16 with f32 parameters;
the encoders return an f32 latent (flax's ``out.astype(float32)``). The
jet computes in ``jet_dtype``, as in the JAX trainer: f32 unless both
``use_bf16`` and ``pde_bf16`` are set (``--pde_bf16`` alone keeps the f32
jet). The fused jet packs the weights in it (at bf16 the bf16 jet
kernels, ``ops/fused_jet.py``); the plain jet (``jet_jnp``) calls the
ImNet in it on the latent cast to it, as JAX's ``imnet.clone(dtype=
jet_dtype)`` on ``latent.astype(jet_dtype)``. The regression-only query
and the eval decode keep the policy (the eval's fused decode takes the
bf16 kernel). The loss and metrics are f32.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn as nn

from space_time_pde_torch.models import (
    ImNet, UNet3d, UNet4d, query_local_implicit_grid)
from space_time_pde_torch.models.nonlinearities import PIECEWISE_LINEAR
from space_time_pde_torch.models.policy import policy_dtype
from space_time_pde_torch.ops.fused_jet import fused_query_jet
from space_time_pde_torch.ops.fused_query import (
    fused_query_local_implicit_grid)
from space_time_pde_torch.ops.jet import query_local_implicit_grid_jet
from space_time_pde_torch.train.optim import Optimizer

__all__ = ["TrainState", "build_models", "flax_init_", "init_state",
           "jet_compute_dtype", "make_loss_fn", "make_train_step",
           "make_multi_step", "make_eval_fn"]

PDE_DERIVS = ("jet", "jet_jnp", "tower")


@dataclass
class TrainState:
    """Step count, the two models (their parameters are the trained
    state), the optimizer state and the run's generator."""
    step: int
    unet: nn.Module
    imnet: ImNet
    opt_state: Dict
    generator: torch.Generator

    def params(self) -> Dict[str, nn.Parameter]:
        """``{"unet.<name>" | "imnet.<name>": parameter}``."""
        out = {f"unet.{k}": p for k, p in self.unet.named_parameters()}
        out.update({f"imnet.{k}": p
                    for k, p in self.imnet.named_parameters()})
        return out

    def buffers(self) -> Dict[str, torch.Tensor]:
        """``{"unet.<name>" | "imnet.<name>": buffer}``: BatchNorm's
        running statistics and batch counters (none with GroupNorm)."""
        out = {f"unet.{k}": b for k, b in self.unet.named_buffers()}
        out.update({f"imnet.{k}": b for k, b in self.imnet.named_buffers()})
        return out


def build_models(cfg, lres_shape: Tuple[int, ...],
                 device="cuda") -> Tuple[nn.Module, ImNet]:
    """The encoder and decoder for a low-res grid of ``lres_shape``:
    UNet3d + ImNet(dim=3) for a (t, z, x) grid (rb2d), UNet4d +
    ImNet(dim=4) for a (t, z, y, x) grid (turb3d, GroupNorm only, as in
    the JAX package's ``experiments/turb3d/train.py``), both computing
    in the policy's dtype (bf16 under ``use_bf16``; parameters f32)."""
    m = cfg.model
    dtype = policy_dtype(m.use_bf16)
    dim = len(lres_shape)
    if dim == 4:
        if m.norm != "group":
            raise ValueError(f"UNet4d has GroupNorm only, got norm "
                             f"{m.norm!r}")
        unet = UNet4d(in_features=m.in_channels, out_features=m.lat_dims,
                      igres=tuple(lres_shape), nf=m.unet_nf, mf=m.unet_mf,
                      negative_slope=m.negative_slope,
                      activation=m.activation, dtype=dtype)
    elif dim == 3:
        unet = UNet3d(in_features=m.in_channels, out_features=m.lat_dims,
                      igres=tuple(lres_shape), nf=m.unet_nf, mf=m.unet_mf,
                      negative_slope=m.negative_slope,
                      activation=m.activation, norm=m.norm, dtype=dtype)
    else:
        raise ValueError(f"no encoder for a {dim}-D grid {lres_shape}")
    imnet = ImNet(dim=dim, in_features=m.lat_dims,
                  out_features=m.out_channels, nf=m.imnet_nf,
                  activation=m.activation, negative_slope=m.negative_slope,
                  dtype=dtype)
    return unet.to(device), imnet.to(device)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's default kernel init: truncated normal on [-2, 2] scaled to
    variance 1 / fan_in (0.8796... is the std of the unit normal
    truncated there)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    cpu = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(cpu, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=gen)
    w.copy_(cpu)


@torch.no_grad()
def flax_init_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Initialise ``module`` as flax initialises its counterpart: kernels
    lecun-normal (fan_in = input features x kernel volume), biases 0,
    norm scales 1 and offsets 0. Draws on the CPU from ``gen``, so a
    seed gives the same weights on any device."""
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv3d)):
            fan_in = mod.weight[0].numel()
        elif isinstance(mod, nn.ConvTranspose3d):
            fan_in = mod.weight.shape[0] * mod.weight[0, 0].numel()
        elif isinstance(mod, (nn.GroupNorm, nn.BatchNorm3d)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            continue
        else:
            continue
        _lecun_normal_(mod.weight, fan_in, gen)
        if mod.bias is not None:
            mod.bias.zero_()
    return module


def init_state(seed: int, unet: nn.Module, imnet: ImNet,
               opt: Optimizer) -> TrainState:
    gen = torch.Generator().manual_seed(seed)
    flax_init_(unet, gen)
    flax_init_(imnet, gen)
    state = TrainState(step=0, unet=unet, imnet=imnet, opt_state={},
                       generator=gen)
    state.opt_state = opt.init({k: p.detach()
                                for k, p in state.params().items()})
    return state


def _reg_loss(kind: str, pred, target):
    err = pred - target
    if kind == "l1":
        return torch.mean(torch.abs(err))
    if kind == "l2":
        return torch.mean(torch.square(err))
    if kind == "huber":
        # optax.losses.huber_loss, delta = 1.
        a = torch.abs(err)
        quadratic = torch.clamp(a, max=1.0)
        return torch.mean(0.5 * quadratic ** 2 + (a - quadratic))
    raise ValueError(f"unknown reg_loss_type {kind!r}")


def jet_compute_dtype(cfg) -> torch.dtype:
    """The jet's compute type: bf16 only under both ``use_bf16`` and
    ``pde_bf16`` (the JAX trainer's ``jet_dtype``), else f32. A bf16 jet
    diverged in a JAX training run (``BASELINE.md`` round 2): the PDE
    residuals are small differences of large terms."""
    return (torch.bfloat16 if cfg.model.use_bf16 and cfg.train.pde_bf16
            else torch.float32)


def make_loss_fn(cfg, unet: nn.Module, imnet: ImNet, pde_layer):
    """loss_fn(batch) -> (loss, metrics dict of 0-d tensors); batch:
    lres [B, *grid, C], point_coord [B, N, D], point_value [B, N, V]
    (D = 3 for rb2d, 4 for turb3d). The parameters are the models'."""
    alpha = cfg.train.alpha_pde
    kind = cfg.train.reg_loss_type
    derivs = cfg.train.pde_derivs
    if derivs not in PDE_DERIVS:
        raise ValueError(f"pde_derivs must be one of {PDE_DERIVS}, got "
                         f"{derivs!r}")
    use_jet = (pde_layer is not None and alpha > 0
               and derivs in ("jet", "jet_jnp")
               and imnet.activation in PIECEWISE_LINEAR
               and pde_layer.max_derivative_order() <= 2)
    use_fused_jet = use_jet and derivs == "jet" and cfg.model.fused_query
    pde_kind = cfg.train.pde_loss_type
    jet_dtype = jet_compute_dtype(cfg)
    # The jet's ImNet in jet_dtype whatever the policy (JAX: imnet.clone(
    # dtype=jet_dtype)); the fused jet packs the weights in it itself.
    jet_imnet = lambda v: imnet(v, dtype=jet_dtype)

    def loss_fn(batch):
        coords = batch["point_coord"]
        unet.train()
        latent = unet(batch["lres"])

        def fwd(pts):
            return query_local_implicit_grid(imnet, latent, pts)

        if use_fused_jet:
            pred, jac, hess = fused_query_jet(imnet, latent, coords,
                                              compute_dtype=jet_dtype)
        elif use_jet:
            # At f32 the latent keeps its type (a float64 model's
            # recomputation stays float64).
            pred, jac, hess = query_local_implicit_grid_jet(
                jet_imnet, latent if jet_dtype == torch.float32
                else latent.to(jet_dtype), coords)
        else:
            pred = fwd(coords)
        reg = _reg_loss(kind, pred, batch["point_value"])
        metrics = {"reg_loss": reg}
        if pde_layer is not None and alpha > 0:
            pde_total, per_eq = pde_layer.residual_loss(
                coords, fwd=fwd, jet=(pred, jac, hess) if use_jet else None,
                kind=pde_kind)
            metrics["pde_loss"] = pde_total
            for n, v in per_eq.items():
                metrics[f"pde/{n}"] = v
            loss = reg + alpha * pde_total
        else:
            loss = reg
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


@contextlib.contextmanager
def _without_cudnn():
    """The step's convolutions on PyTorch's own kernels (im2col + f32
    GEMM), not cuDNN's: on the rb2d flagship step on an H100 (TF32 off),
    cuDNN's f32 convolutions left the UNet's gradients a median 4.2x
    farther from a float64 recomputation than JAX's f32 CPU step, and as
    far (4.2x) with cuDNN in the forward only, so the loss is in cuDNN's
    forward; PyTorch's own kernels in both directions 0.4x
    (``chip_smoke.py``'s training-step phase). UNet4d's spatial
    ``Conv3d`` takes the same path; its temporal conv is a plain matrix
    product either way (``models/unet4d.py``). Under the bf16 policy the
    step keeps this path: PyTorch's own CUDA convolutions take bf16
    operands, and on the flagship step their gradients sit a median
    0.99x JAX bf16's distance from float64 (``chip_smoke.py`` phase I,
    H100)."""
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


def _first_non_finite(tensors: Dict[str, torch.Tensor]):
    """The name of the first tensor holding a NaN or Inf, or None."""
    for k, t in tensors.items():
        if not bool(torch.isfinite(t).all()):
            return k
    return None


def make_train_step(loss_fn, opt: Optimizer, debug_nans: bool = False,
                    sync=None):
    """step(state, batch) -> (state, metrics): one optimizer step,
    updating the models' parameters and ``state`` in place (the step's
    gradients stay in the parameters' ``.grad``). ``debug_nans``: check
    the loss terms after the forward and the gradients after the
    backward, and raise ``FloatingPointError`` naming the first
    non-finite one, before the optimizer touches anything (a host sync
    each; the JAX drivers' ``jax_debug_nans``). ``sync(grads, metrics)``
    replaces both dicts' values with their all-reduced ones after the
    backward (``parallel/dp.py::make_grad_sync``); the optimizer sees
    the reduced gradients."""

    def step(state: TrainState, batch):
        params = state.params()
        for p in params.values():
            p.grad = None
        with _without_cudnn():
            loss, metrics = loss_fn(batch)
            bad = debug_nans and _first_non_finite(metrics)
            if bad:
                raise FloatingPointError(
                    f"non-finite loss term {bad!r} at step {state.step}")
            loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        if sync is not None:
            sync(grads, metrics)
            for k, p in params.items():
                p.grad = grads[k]
        bad = debug_nans and _first_non_finite(grads)
        if bad:
            raise FloatingPointError(
                f"non-finite gradient of {bad!r} at step {state.step}")
        metrics["grad_norm"] = opt.step(params, grads, state.opt_state)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_multi_step(loss_fn, opt: Optimizer, n_inner: int,
                    debug_nans: bool = False, sync=None):
    """step(state, stacked_batch): ``n_inner`` sequential steps over
    batches stacked on a leading axis; returns the last step's
    metrics."""
    one = make_train_step(loss_fn, opt, debug_nans, sync)

    def step(state: TrainState, stacked_batch):
        metrics = {}
        for g in range(n_inner):
            state, metrics = one(state, {k: v[g] for k, v in
                                         stacked_batch.items()})
        return state, metrics

    return step


def make_eval_fn(cfg, unet: nn.Module, imnet: ImNet):
    """Relative L2 of predictions vs point ground truth (overall and per
    channel), through the fused decode (the CUDA decode kernel on a
    card, its bf16 instantiation under ``use_bf16``) when
    ``fused_query`` is set; the encoder in eval mode."""
    dtype = policy_dtype(cfg.model.use_bf16)

    @torch.no_grad()
    def eval_fn(batch):
        unet.eval()
        latent = unet(batch["lres"])
        coords = batch["point_coord"]
        if cfg.model.fused_query:
            pred = fused_query_local_implicit_grid(imnet, latent, coords,
                                                   compute_dtype=dtype)
        else:
            pred = query_local_implicit_grid(imnet, latent, coords)
        target = batch["point_value"]
        sq = torch.square(pred - target)
        num = torch.sqrt(torch.sum(sq))
        den = torch.sqrt(torch.sum(torch.square(target))) + 1e-12
        per_num = torch.sqrt(torch.sum(sq, (0, 1)))
        per_den = torch.sqrt(torch.sum(torch.square(target), (0, 1))) + 1e-12
        return {"rel_l2": num / den, "rel_l2_per_channel": per_num / per_den}

    return eval_fn
