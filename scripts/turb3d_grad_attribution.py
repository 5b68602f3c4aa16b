"""Which op of the turb3d training step puts its gradients farther from
float64 than JAX's float32 step: the step recomputed with one candidate op
at a time in float64.

    python scripts/turb3d_grad_attribution.py [--out FILE] [--candidates a,b]
    python scripts/turb3d_grad_attribution.py --seeds 8

Takes the step of ``chip_smoke.py``'s turb3d training phase
(``reference_step`` on ``assets/turb3d_train_step_ref.npz``: the recipe's
widths, the seeded weights, the exported batch) and scores its gradients
as that phase does (``check_step``): per leaf, the relative L2 distance
from the file's float64 leaf over JAX float32's own (``relnorm/``), their
median and max over the leaves, and the five worst; beside it the worst
``atol`` a leaf needs at rtol 1e-4, in units of its scale. The step runs
eagerly (the captured step equals it bit for bit) with the gradients
alone, no optimizer update. Candidates (``CANDIDATES``), each a context
that recomputes one op in float64, its inputs cast up and its outputs
rounded once to float32, forward and backward, everything else as
shipped:

- ``shipped``: nothing changed (run twice: the step is deterministic);
- ``temporal``: ``Conv4d``'s temporal product and its bias
  (``models/unet4d.py::Conv4d._conv_time``);
- ``spatial``: ``Conv4d``'s spatial ``Conv3d`` (``_conv_space``), the
  step's cuDNN-free path;
- ``groupnorm``: every ``GroupNorm`` of the encoder;
- ``jet_plain``: the fused jet kernels replaced by the plain jet in
  float32 (``ops/jet.py``, torch's own f32 products), and ``jet64``: the
  plain jet in float64;
- ``pde``: the ns3d layer's residuals and their Huber means
  (``physics/pde.py::PDELayer.residual_loss``) on the jet's outputs;
- ``unet``: ``temporal`` + ``spatial`` + ``groupnorm``;
- ``all64``: the whole step in float64 on the card (``chip_smoke.py``'s
  ``float64_step``), the floor.

Halves of an op (``_Mixed``: the forward in float64 or in f32, some
inputs' gradients recomputed in float64, the rest the f32 backward):
``temporal_f32`` (all of it in f32, the form before ``_TimeProduct``)
and, each against that form, ``temporal_fwd`` / ``_dgrad`` /
``_wgrad`` (the product's forward; its input's gradient; its weight's
and bias's, cuBLAS's split-K reduction); ``gn_fwd`` / ``gn_bwd``. Other
f32 forms: the temporal weight gradient as 256-row blocks summed in a
fixed order (``temporal_blocked``), GroupNorm as explicit ops with
flax's variance or a two-pass one (``gn_flax_ops``,
``gn_two_pass_ops``). Names joined by ``+`` run together.

Beside each reading, the LeakyReLU branches that differ from float64's:
the encoder's, as the step took them, and the decoder's, the ImNet run
in float64 on the step's latents at every corner of the batch's points
(the branches the latents move; a jet kernel's own f32 flips are not
counted). A branch taken within rounding of 0 moves a gradient by a
finite step, so a reading dominated by such events moves between
candidates that change the rounding anywhere.

``--seeds N`` asks whether a candidate's gain holds beyond the one
reference: no JAX yardstick, the same batch under the weights of seeds
1..N, each candidate's median over the leaves of its rel-L2 distance
from the card's float64 step, with the branches off float64's (default
``temporal_f32`` against ``shipped``).

Prints one line a candidate and the card's name and power limit, writes
the table as JSON to ``--out``. Needs a CUDA device (``--device cpu``
runs the plain twins; tiny references only: the recipe's step is too
large for a shared CPU).
"""

import argparse
import contextlib
import copy
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from space_time_pde_torch.models import unet3d, unet4d  # noqa: E402
from space_time_pde_torch.ops.grid_interp import (  # noqa: E402
    _locate, corner_offsets, gather_corner_feats)
from space_time_pde_torch.ops.jet import (  # noqa: E402
    query_local_implicit_grid_jet)
from space_time_pde_torch.physics.pde import PDELayer  # noqa: E402
from space_time_pde_torch.train import trainer  # noqa: E402

F64 = torch.float64


@contextlib.contextmanager
def patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _temporal64(self, cols):
    w = self.temporal.weight.to(F64)
    h = cols.to(F64) @ w.reshape(w.shape[0], -1).t()
    if self.temporal.bias is not None:
        h = h + self.temporal.bias.to(F64)
    return h.float()


def _spatial64(self, h):
    conv = self.spatial
    x = unet3d.same_pad(h.to(F64), self.ks, self.stride)
    return F.conv3d(x, conv.weight.to(F64), None, conv.stride, conv.padding,
                    conv.dilation, conv.groups).float()


def _group_norm64(self, x):
    return torch.group_norm(x.to(F64), self.num_groups,
                            self.weight.to(F64), self.bias.to(F64), self.eps,
                            False).float()


def _jet(dtype):
    def jet(imnet, latent, coords, compute_dtype=torch.float32):
        params = {k: p.to(dtype) for k, p in imnet.named_parameters()}
        fn = lambda v: torch.func.functional_call(imnet, params, (v,))
        out = query_local_implicit_grid_jet(fn, latent.to(dtype),
                                            coords.to(dtype))
        return tuple(t.float() for t in out)
    return jet


_residual_loss = PDELayer.residual_loss


def _residual_loss64(self, coords, fwd=None, jet=None, kind="l2",
                     huber_delta=1.0):
    jet = tuple(t.to(F64) for t in jet)
    total, per_eq = _residual_loss(self, coords.to(F64), fwd=fwd, jet=jet,
                                   kind=kind, huber_delta=huber_delta)
    return total.float(), {k: v.float() for k, v in per_eq.items()}


class _Mixed(torch.autograd.Function):
    """``fn(*xs)`` with its forward in float64 (``fwd64``, rounded once)
    or as shipped, and the gradients of the inputs whose indices are in
    ``bwd64`` recomputed in float64; every other gradient is the shipped
    f32 backward of ``fn`` (autograd through an f32 recomputation)."""

    @staticmethod
    def forward(ctx, fn, fwd64, bwd64, *xs):
        ctx.fn, ctx.bwd64 = fn, bwd64
        ctx.save_for_backward(*xs)
        if fwd64:
            return fn(*[x.to(F64) for x in xs]).float()
        return fn(*xs)

    @staticmethod
    def backward(ctx, g):
        xs = ctx.saved_tensors
        out = []
        for dtype in (torch.float32, F64):
            if dtype == F64 and not ctx.bwd64:
                break
            with torch.enable_grad():
                ins = [x.detach().to(dtype).requires_grad_() for x in xs]
                gs = torch.autograd.grad(ctx.fn(*ins), ins, g.to(dtype))
            out.append([t.float() for t in gs])
        gs = [out[1][i] if i in ctx.bwd64 else out[0][i]
              for i in range(len(xs))]
        return (None, None, None, *gs)


def _temporal_mixed(fwd64, bwd64):
    def conv_time(self, cols):
        w, b = self.temporal.weight, self.temporal.bias
        if b is None:
            fn = lambda c, w: c @ w.reshape(w.shape[0], -1).t()
            return _Mixed.apply(fn, fwd64, bwd64, cols, w)
        fn = lambda c, w, b: c @ w.reshape(w.shape[0], -1).t() + b
        return _Mixed.apply(fn, fwd64, bwd64, cols, w, b)
    return conv_time


def _group_norm_mixed(fwd64, bwd64):
    def forward(self, x):
        fn = lambda x, w, b: torch.group_norm(x, self.num_groups, w, b,
                                              self.eps, False)
        return _Mixed.apply(fn, fwd64, bwd64, x, self.weight, self.bias)
    return forward


def _group_norm_ops(two_pass):
    """GroupNorm as explicit ops: flax's (mean and mean of squares, the
    variance their difference, then (x - mean) rsqrt(var + eps) scale +
    bias) or, with ``two_pass``, the variance as the mean of (x -
    mean)^2."""
    def forward(self, x):
        b, c = x.shape[:2]
        xg = x.reshape(b, self.num_groups, -1)
        mean = xg.mean(-1, keepdim=True)
        if two_pass:
            var = (xg - mean).square().mean(-1, keepdim=True)
        else:
            var = torch.clamp(xg.square().mean(-1, keepdim=True)
                              - mean.square(), min=0.0)
        shape = (1, c) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps)
        y = ((xg - mean) * mul).reshape(x.shape)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)
    return forward


class _BlockedTime(torch.autograd.Function):
    """``cols @ wt + b`` whose weight gradient sums row blocks of
    ``ROWS`` in a fixed order (a batched product, then a sum over the
    blocks) instead of one product over every row."""

    ROWS = 256

    @staticmethod
    def forward(ctx, cols, wt, b):
        ctx.save_for_backward(cols, wt)
        ctx.has_bias = b is not None
        y = cols @ wt
        return y + b if b is not None else y

    @staticmethod
    def backward(ctx, g):
        cols, wt = ctx.saved_tensors
        n, r = cols.shape[0], _BlockedTime.ROWS
        nb = -(-n // r)
        pad = nb * r - n
        cp = F.pad(cols, (0, 0, 0, pad)).reshape(nb, r, -1)
        gp = F.pad(g, (0, 0, 0, pad)).reshape(nb, r, -1)
        dwt = torch.bmm(cp.transpose(1, 2), gp).sum(0)
        return g @ wt.t(), dwt, g.sum(0) if ctx.has_bias else None


def _temporal_blocked(self, cols):
    w = self.temporal.weight
    wt = w.reshape(w.shape[0], -1).t()
    return _BlockedTime.apply(cols, wt, self.temporal.bias)


def _ctx(*patches):
    def enter():
        stack = contextlib.ExitStack()
        for owner, name, value in patches:
            stack.enter_context(patched(owner, name, value))
        return stack
    return enter


TEMPORAL = (unet4d.Conv4d, "_conv_time", _temporal64)
SPATIAL = (unet4d.Conv4d, "_conv_space", _spatial64)
GROUPNORM = (unet3d.GroupNorm, "forward", _group_norm64)
CANDIDATES = {
    "shipped": _ctx(),
    "temporal": _ctx(TEMPORAL),
    "spatial": _ctx(SPATIAL),
    "groupnorm": _ctx(GROUPNORM),
    "jet_plain": _ctx((trainer, "fused_query_jet", _jet(torch.float32))),
    "jet64": _ctx((trainer, "fused_query_jet", _jet(F64))),
    "pde": _ctx((PDELayer, "residual_loss", _residual_loss64)),
    "unet": _ctx(TEMPORAL, SPATIAL, GROUPNORM),
    "temporal_f32": _ctx((unet4d.Conv4d, "_conv_time",
                          _temporal_mixed(False, ()))),
    "temporal_fwd": _ctx((unet4d.Conv4d, "_conv_time",
                          _temporal_mixed(True, ()))),
    "temporal_dgrad": _ctx((unet4d.Conv4d, "_conv_time",
                            _temporal_mixed(False, (0,)))),
    "temporal_wgrad": _ctx((unet4d.Conv4d, "_conv_time",
                            _temporal_mixed(False, (1, 2)))),
    "gn_fwd": _ctx((unet3d.GroupNorm, "forward",
                    _group_norm_mixed(True, ()))),
    "gn_bwd": _ctx((unet3d.GroupNorm, "forward",
                    _group_norm_mixed(False, (0, 1, 2)))),
    "temporal_blocked": _ctx((unet4d.Conv4d, "_conv_time",
                              _temporal_blocked)),
    "gn_flax_ops": _ctx((unet3d.GroupNorm, "forward",
                         _group_norm_ops(False))),
    "gn_two_pass_ops": _ctx((unet3d.GroupNorm, "forward",
                             _group_norm_ops(True))),
    "all64": None,
}


@contextlib.contextmanager
def encoder_branches(unet, store):
    """Append each encoder LeakyReLU's branches (``x > 0``) to ``store``,
    in call order, while the context is open."""
    acts = {m: m.act for m in unet.modules()
            if callable(getattr(m, "act", None))}
    for m, act in acts.items():
        m.act = (lambda a: lambda x: (store.append((x > 0).detach()),
                                      a(x))[1])(act)
    try:
        yield
    finally:
        for m, act in acts.items():
            m.act = act


def decoder_branches(imnet64, latent, coords):
    """The ImNet's LeakyReLU branches at every corner of every point of
    the batch, run in float64 on ``latent`` (the value pass, whose
    branches the jet's tangent passes share): [layer masks]."""
    store = []
    act = imnet64.act
    imnet64.act = lambda x: (store.append(x > 0), act(x))[1]
    try:
        with torch.no_grad():
            for grid, p in zip(latent.to(F64), coords.to(F64)):
                spatial = tuple(grid.shape[:-1])
                cell, frac = _locate(p, spatial, 0.0, 1.0)
                feats = gather_corner_feats(grid, cell)
                offs = torch.as_tensor(corner_offsets(len(spatial)),
                                       dtype=F64, device=grid.device)
                rel = frac[:, None, :] - offs[None]
                imnet64(torch.cat([rel, feats], dim=-1))
    finally:
        imnet64.act = act
    return store


def flips(got, want):
    return int(sum((a != b).sum() for a, b in zip(got, want)))


def step_grads(cfg, pde, state, batch, store=None):
    """{leaf: gradient} of one step's loss (no update), as float64 numpy,
    and the encoder's output; ``store`` collects the encoder's
    branches."""
    params = state.params()
    for p in params.values():
        p.grad = None
    loss_fn = trainer.make_loss_fn(cfg, state.unet, state.imnet, pde)
    latent = []
    hook = state.unet.register_forward_hook(
        lambda m, i, out: latent.append(out.detach()))
    try:
        with trainer._without_cudnn(), \
                encoder_branches(state.unet, [] if store is None else store):
            loss, _ = loss_fn(batch)
            loss.backward()
    finally:
        hook.remove()
    return {f"{name}.{k}": p.grad.double().cpu().numpy()
            for name, mod in (("unet", state.unet), ("imnet", state.imnet))
            for k, p in mod.named_parameters()}, latent[0]


def score(grads, ref, rtol):
    """check_step's readings of ``grads`` against the file's float64
    leaves: rel-L2 over JAX f32's (median, max, the five worst) and the
    worst atol a leaf needs (x its scale)."""
    ratio, need = {}, {}
    for key, g in grads.items():
        g64 = ref[f"grad64/{key}"].astype(np.float64)
        jax = float(ref[f"relnorm/{key}"])
        rel = float(np.linalg.norm(g - g64) / np.linalg.norm(g64))
        if jax > 0:
            ratio[key] = rel / jax
        need[key] = chip_smoke.atol_needed(g, g64, float(ref[f"scale/{key}"]),
                                           rtol)
    worst = sorted(ratio, key=ratio.get)[-5:][::-1]
    return {"median": float(np.median(list(ratio.values()))),
            "max": float(max(ratio.values())),
            "worst": [[k, ratio[k]] for k in worst],
            "worst_atol": float(max(need.values())),
            "ratios": ratio}


def float64_branches(state, batch):
    """Float64's LeakyReLU branches: the encoder's, and the decoder's on
    float64's latents (with the float64 ImNet that reads them)."""
    unet64 = copy.deepcopy(state.unet).double()
    imnet64 = copy.deepcopy(state.imnet).double()
    enc64 = []
    with torch.no_grad(), encoder_branches(unet64, enc64):
        latent64 = unet64(batch["lres"].double())
    return enc64, decoder_branches(imnet64, latent64, batch["point_coord"]), \
        imnet64


def run_candidate(name, cfg, pde, state, batch, imnet64):
    """(gradients, encoder branches, decoder branches) of the step with
    candidate ``name`` (``all64``: the float64 step; its branches are
    not read here, (None, None))."""
    parts = name.split("+")
    if any(n not in CANDIDATES or n == "all64" and len(parts) > 1
           for n in parts):
        raise SystemExit(f"unknown candidate {name!r}; available: "
                         f"{list(CANDIDATES)}, joined by '+'")
    if name == "all64":
        weights = {"unet": state.unet.state_dict(),
                   "imnet": state.imnet.state_dict()}
        grads = chip_smoke.float64_step(cfg, weights, pde, batch)[0]
        return {k: g.astype(np.float64) for k, g in grads.items()}, \
            None, None
    enc = []
    with contextlib.ExitStack() as stack:
        for n in parts:
            stack.enter_context(CANDIDATES[n]())
        grads, latent = step_grads(cfg, pde, state, batch, enc)
    return grads, enc, decoder_branches(imnet64, latent,
                                        batch["point_coord"])


def attribution(names, cfg, pde, state, batch, ref, rtol):
    """The table: {candidate: score + branch counts}."""
    enc64, dec64, imnet64 = float64_branches(state, batch)
    rows = {}
    for name in names:
        for i in range(2 if name == "shipped" else 1):
            grads, enc, dec = run_candidate(name, cfg, pde, state, batch,
                                            imnet64)
            if i:
                same = all(np.array_equal(grads[k], first[k]) for k in grads)
                rows[name]["repeat_bit_for_bit"] = same
                print(f"  {name}: a second run equals the first bit for "
                      f"bit: {same}", flush=True)
                continue
            first = grads
            r = rows[name] = score(grads, ref, rtol)
            r["encoder_flips"] = flips(enc or enc64, enc64)
            r["decoder_flips"] = flips(dec or dec64, dec64)
            print(f"{name:10s} rel-L2 from float64 / JAX f32's: median "
                  f"{r['median']:.3f}, max {r['max']:.3f}; LeakyReLU "
                  f"branches off float64's: encoder {r['encoder_flips']}, "
                  f"decoder {r['decoder_flips']}; worst atol "
                  f"{r['worst_atol']:.3e} x scale; worst leaves "
                  + ", ".join(f"{k} {v:.2f}" for k, v in r["worst"]),
                  flush=True)
    return rows


def over_seeds(names, seeds, cfg, pde, state, batch, spec):
    """The step's own distance from float64 (no JAX yardstick) under each
    candidate, for the reference's batch with the weights of each seed
    in 1..``seeds`` (``seeded_flax_params``): per seed and candidate the
    median over the leaves of each leaf's rel-L2 distance from the card's
    float64 step, and the branches off float64's. Leaves whose float64
    gradient is below 1e-5 of the model's largest are left out."""
    from space_time_pde_torch.bridge import (
        load_flax_params, seeded_flax_params)

    out = []
    for seed in range(1, seeds + 1):
        params = seeded_flax_params(spec["shapes"], seed)
        load_flax_params(state.unet, params["unet"],
                         chip_smoke.buffers_as_flax(state.unet))
        load_flax_params(state.imnet, params["imnet"])
        enc64, dec64, imnet64 = float64_branches(state, batch)
        g64 = run_candidate("all64", cfg, pde, state, batch, imnet64)[0]
        top = max(float(np.abs(g).max()) for g in g64.values())
        keys = [k for k, g in g64.items() if np.abs(g).max() > 1e-5 * top]
        row = {"seed": seed}
        for name in names:
            grads, enc, dec = run_candidate(name, cfg, pde, state, batch,
                                            imnet64)
            rel = [float(np.linalg.norm(grads[k] - g64[k])
                         / np.linalg.norm(g64[k])) for k in keys]
            row[name] = {"median_rel": float(np.median(rel)),
                         "encoder_flips": flips(enc, enc64),
                         "decoder_flips": flips(dec, dec64)}
        print(f"weights of seed {seed}: median over {len(keys)} leaves of "
              "rel-L2 from float64: " + "; ".join(
                  f"{n} {row[n]['median_rel']:.3e} (branches off: encoder "
                  f"{row[n]['encoder_flips']}, decoder "
                  f"{row[n]['decoder_flips']})" for n in names), flush=True)
        out.append(row)
    for n in names:
        print(f"{n}: median over the {seeds} seeds of the median rel-L2 "
              f"{np.median([r[n]['median_rel'] for r in out]):.3e}",
              flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ref", default=chip_smoke.TURB3D_STEP_REF)
    p.add_argument("--device", default="cuda")
    p.add_argument("--candidates", default="",
                   help="comma-separated names of CANDIDATES (default: "
                        "all; with --seeds, temporal_f32,shipped)")
    p.add_argument("--seeds", type=int, default=0,
                   help="score the candidates against the card's float64 "
                        "step under the weights of seeds 1..N instead")
    p.add_argument("--out", default="",
                   help="write the table here as JSON")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = chip_smoke.card_line()
    else:
        card = "cpu"
    print(f"card: {card}", flush=True)
    cfg, pde, _, state, batch, ref, spec = chip_smoke.reference_step(
        args.ref, device)
    names = [n for n in args.candidates.split(",") if n] or (
        ["temporal_f32", "shipped"] if args.seeds else list(CANDIDATES))
    out = {"card": card, "ref": os.path.relpath(args.ref, ROOT)}
    if args.seeds:
        out["seeds"] = over_seeds(names, args.seeds, cfg, pde, state, batch,
                                  spec)
    else:
        out["candidates"] = attribution(names, cfg, pde, state, batch, ref,
                                        spec["grad_rtol"])
        print(json.dumps({k: {m: v for m, v in r.items() if m != "ratios"}
                          for k, r in out["candidates"].items()}),
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
