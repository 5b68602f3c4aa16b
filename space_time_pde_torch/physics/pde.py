"""Symbolic PDE residual layer -- the ``dif`` mini-DSL (PyTorch).

Counterpart of ``space_time_pde_tpu/physics/pde.py``. Equations are
sympy-parseable strings over the output fields and coordinates with the
derivative operator ``dif(f, v)`` (nested for higher order; ``lhs =
rhs`` means the residual ``lhs - rhs``). At ``add_equation`` time
``dif`` parses to ``sympy.Derivative``; ``.doit()`` pushes derivatives
through products and compositions once, the needed derivative
multi-indices are collected across equations, and each residual is
lambdified into a closure over torch tensors.

Derivatives come either from a precomputed analytic jet (value, Jacobian
and Hessian of the decoder, ``ops/jet.py`` or ``ops/fused_jet.py``) or
from nested forward-mode towers (``torch.func.jvp``) through a bound
forward method -- the jet's CPU oracle and the ``--pde_derivs tower``
training mode. ``set_scaling`` declares the normalisation between the
forward method's units and the physical units of the equations.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import sympy as sp
import torch
from sympy.core.function import AppliedUndef
from torch.func import jvp

from space_time_pde_torch.utils.constants import device_constant

__all__ = ["PDELayer"]

MultiIndex = Tuple[int, ...]  # sorted coordinate-axis indices, e.g. (0,), (2,2)

# sympy name -> torch callable (``pi`` as a float): the functions an
# equation may use.
_TORCH_FUNCS = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "Abs": torch.abs, "pi": math.pi, "Max": torch.maximum,
    "Min": torch.minimum, "sign": torch.sign,
}


def _split_names(csv: str) -> List[str]:
    names = [s.strip() for s in csv.split(",") if s.strip()]
    if not names:
        raise ValueError(f"empty variable list: {csv!r}")
    return names


class PDELayer:
    """Physics-residual layer over a bound forward method.

    Example::

        layer = PDELayer(in_vars="t, z, x", out_vars="p, b, u, w")
        layer.add_equation("dif(u, x) + dif(w, z) = 0", name="continuity")
        layer.update_forward_method(fwd)   # fwd: [..., 3] -> [..., 4]
        residuals = layer(coords)          # {"continuity": [..., ]}
    """

    def __init__(self, in_vars: str, out_vars: str):
        self.in_var_names = _split_names(in_vars)
        self.out_var_names = _split_names(out_vars)
        self.coord_syms = sp.symbols(self.in_var_names)
        if len(self.in_var_names) == 1:
            self.coord_syms = (self.coord_syms,)
        self.func_syms = {
            n: sp.Function(n)(*self.coord_syms) for n in self.out_var_names
        }
        self._axis_of_sym = {s: i for i, s in enumerate(self.coord_syms)}
        self._eqs: List[Tuple[str, sp.Expr]] = []
        self._lowered: Optional[List[Tuple[str, Callable, List]]] = None
        self.fwd: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
        self._coord_scales: Optional[Sequence[float]] = None
        self._out_means = None
        self._out_stds = None

    # ------------------------------------------------------------------ API

    def add_equation(self, eqn: str, name: Optional[str] = None) -> None:
        """``"expr"`` means residual = expr; ``"lhs = rhs"`` means
        residual = lhs - rhs."""
        if "=" in eqn and "==" not in eqn:
            lhs_s, rhs_s = eqn.split("=", 1)
            expr = self._parse(lhs_s) - self._parse(rhs_s)
        else:
            expr = self._parse(eqn.replace("==", "="))
        name = name or f"eq{len(self._eqs)}"
        self._eqs.append((name, expr))
        self._lowered = None

    def update_forward_method(self, fwd) -> None:
        """Bind the forward method: coords [..., D] -> outs [..., V] in
        its own (normalised) units."""
        self.fwd = fwd

    def set_scaling(self, coord_scales=None, out_means=None, out_stds=None):
        """physical s_a = s0_a + coord_scales[a] * (normalised);
        physical y_c = out_means[c] + out_stds[c] * (normalised)."""
        self._coord_scales = coord_scales
        self._out_means = out_means
        self._out_stds = out_stds

    @property
    def equation_names(self) -> List[str]:
        return [n for n, _ in self._eqs]

    def max_derivative_order(self) -> int:
        order = 0
        for _, _, atom_keys in self._lower_all():
            for k in atom_keys:
                if isinstance(k, tuple):
                    order = max(order, len(k[1]))
        return order

    def __call__(self, coords: torch.Tensor, return_outs: bool = False,
                 fwd=None, jet=None):
        """Residuals ``{name: [...]}`` at coords ``[..., D]``
        (normalised units). ``jet``: a callable ``coords -> (outs, jac,
        hess)`` or such a tuple (``[..., V]``, ``[..., V, D]``,
        ``[..., V, D, D]``), for systems of order <= 2; otherwise nested
        jvp towers through ``fwd`` (or the bound forward method)."""
        lowered = self._lower_all()
        needed = set()
        for _, _, atom_keys in lowered:
            needed.update(k for k in atom_keys if isinstance(k, tuple))
        if jet is not None:
            if self.max_derivative_order() > 2:
                raise ValueError(
                    "jet path supports derivative order <= 2; this "
                    f"system needs order {self.max_derivative_order()}")
            outs, jac, hess = jet(coords) if callable(jet) else jet
            derivs = self._derivs_from_jet(coords, needed, outs, jac, hess)
        else:
            fwd = fwd or self.fwd
            if fwd is None:
                raise RuntimeError("call update_forward_method(fwd) first")
            derivs = self._compute_derivs(coords, needed, fwd)

        coords_phys = self._physical_coords(coords)
        residuals = {}
        for name, fn, atom_keys in lowered:
            args = []
            for k in atom_keys:
                if isinstance(k, tuple):
                    args.append(derivs[k])
                else:
                    args.append(coords_phys[..., self._axis_by_name(k)])
            r = fn(*args)
            if not isinstance(r, torch.Tensor):
                # An equation that sympy reduced to a constant (e.g. an
                # identity): one value per point, like the rest.
                r = torch.full(coords.shape[:-1], float(r),
                               dtype=coords.dtype, device=coords.device)
            residuals[name] = r
        if return_outs:
            return residuals, derivs["__outs__"]
        return residuals

    def residual_loss(self, coords: torch.Tensor, fwd=None, jet=None,
                      kind: str = "l2", huber_delta: float = 1.0):
        """(sum over equations, {name: penalty}) with the mean-square
        penalty (``l2``) or the Huber penalty (quadratic up to
        ``huber_delta``, linear beyond)."""
        res = self(coords, fwd=fwd, jet=jet)
        if kind == "huber":
            d = huber_delta

            def pen(r):
                a = torch.abs(r)
                return torch.mean(torch.where(a <= d, 0.5 * r * r,
                                              d * (a - 0.5 * d)))
        elif kind == "l2":
            def pen(r):
                return torch.mean(torch.square(r))
        else:
            raise ValueError(f"unknown pde loss kind: {kind!r}")
        per_eq = {n: pen(r) for n, r in res.items()}
        total = sum(per_eq.values())
        return total, per_eq

    # ------------------------------------------------------------ internals

    def _axis_by_name(self, name: str) -> int:
        return self.in_var_names.index(name)

    def _parse(self, s: str) -> sp.Expr:
        local = {"dif": sp.Derivative}
        local.update({n: self.func_syms[n] for n in self.out_var_names})
        local.update(
            {n: sym for n, sym in zip(self.in_var_names, self.coord_syms)})
        return sp.sympify(s, locals=local)

    def _lower_all(self):
        if self._lowered is None:
            self._lowered = [self._lower(name, expr)
                             for name, expr in self._eqs]
        return self._lowered

    def _lower(self, name: str, expr: sp.Expr):
        """Expand derivatives symbolically and lambdify over atoms."""
        expr = expr.doit()
        subs = {}
        atom_keys: List = []
        placeholders: List[sp.Symbol] = []

        def _register(atom, key):
            ph = sp.Symbol(f"__a{len(placeholders)}")
            subs[atom] = ph
            placeholders.append(ph)
            atom_keys.append(key)

        for d in sorted(expr.atoms(sp.Derivative), key=sp.default_sort_key):
            f = d.expr
            if not isinstance(f, AppliedUndef):
                raise ValueError(
                    f"equation {name!r}: derivative of non-output "
                    f"expression remained after expansion: {d}")
            var = f.func.__name__
            if var not in self.out_var_names:
                raise ValueError(f"unknown field {var!r} in {d}")
            alpha: List[int] = []
            for sym, count in d.variable_count:
                if sym not in self._axis_of_sym:
                    raise ValueError(f"dif w.r.t. non-coordinate {sym}")
                alpha.extend([self._axis_of_sym[sym]] * int(count))
            _register(d, (var, tuple(sorted(alpha))))

        for f in sorted(expr.atoms(AppliedUndef), key=sp.default_sort_key):
            if f in subs:
                continue
            var = f.func.__name__
            if var not in self.out_var_names:
                raise ValueError(f"unknown field {var!r}")
            _register(f, (var, ()))

        expr = expr.subs(subs)
        free = expr.free_symbols
        for i, sym in enumerate(self.coord_syms):
            if sym in free:
                ph = sp.Symbol(f"__a{len(placeholders)}")
                expr = expr.subs(sym, ph)
                placeholders.append(ph)
                atom_keys.append(self.in_var_names[i])
        fn = sp.lambdify(placeholders, expr, modules=[_TORCH_FUNCS])
        return name, fn, atom_keys

    def _physical_coords(self, coords):
        if self._coord_scales is None:
            return coords
        return coords * device_constant(self._coord_scales, coords.dtype,
                                        coords.device)

    def _scales(self, like):
        const = lambda v: (None if v is None
                           else device_constant(v, like.dtype, like.device))
        return (const(self._out_stds), const(self._out_means),
                const(self._coord_scales))

    def _physical(self, var, alpha, val, phys_primal, stds, scales):
        """One derivative tensor in physical units."""
        c = self.out_var_names.index(var)
        if alpha == ():
            return phys_primal[..., c]
        if stds is not None:
            val = val * stds[c]
        if scales is not None:
            val = val / torch.prod(torch.stack([scales[a] for a in alpha]))
        return val

    def _compute_derivs(self, coords, needed: set, fwd):
        """All needed derivative tensors by nested jvp towers, plus
        ``"__outs__"``: the primal outputs, all in physical units."""

        def unit(c, axis):
            t = torch.zeros(c.shape[-1], dtype=c.dtype, device=c.device)
            t[axis] = 1.0
            return t.expand(c.shape)

        def deriv_fn(alpha: MultiIndex):
            f = fwd
            for ax in alpha:
                f = (lambda c, f=f, ax=ax: jvp(f, (c,), (unit(c, ax),))[1])
            return f

        alphas = sorted({alpha for _, alpha in needed} | {()})
        raw = {alpha: deriv_fn(alpha)(coords) for alpha in alphas}
        stds, means, scales = self._scales(coords)
        phys_primal = raw[()]
        if stds is not None:
            phys_primal = phys_primal * stds
        if means is not None:
            phys_primal = phys_primal + means
        out = {"__outs__": phys_primal}
        for var, alpha in needed:
            c = self.out_var_names.index(var)
            out[(var, alpha)] = self._physical(
                var, alpha, raw[alpha][..., c], phys_primal, stds, scales)
        return out

    def _derivs_from_jet(self, coords, needed: set, outs, jac, hess):
        """Derivative tensors from a precomputed analytic jet (normalised
        units in, physical units out, as ``_compute_derivs``)."""
        stds, means, scales = self._scales(coords)
        phys_primal = outs
        if stds is not None:
            phys_primal = phys_primal * stds
        if means is not None:
            phys_primal = phys_primal + means
        out = {"__outs__": phys_primal}
        for var, alpha in needed:
            c = self.out_var_names.index(var)
            if len(alpha) == 0:
                val = None
            elif len(alpha) == 1:
                val = jac[..., c, alpha[0]]
            elif len(alpha) == 2:
                val = hess[..., c, alpha[0], alpha[1]]
            else:
                raise ValueError(
                    f"jet path got order-{len(alpha)} derivative")
            out[(var, alpha)] = self._physical(var, alpha, val, phys_primal,
                                               stds, scales)
        return out
