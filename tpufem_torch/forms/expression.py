"""Per-cell expression evaluation at reference points.

Equivalent of ``fem::create_expression`` + ``Function::interpolate(expr)``
(FEniCSx/mechanic2d/asym_elasto_damage_model.cc:924-941; expressions
defined at asym_ufl.py:86-97) and of ``tpufem.forms.expression``:
evaluate an arbitrary function of the solution's value / gradient and
coefficients at fixed reference points of every cell (e.g. the centroid,
for DG0 strain/stress output).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
from torch.func import vmap

from tpufem_torch.elements.geometry import inv as small_inv
from tpufem_torch.forms.form import QP, EnergyFunctional


def evaluate_expression(
    functional: EnergyFunctional,
    fn: Callable[[QP], torch.Tensor],
    u: torch.Tensor,
    coeffs: Dict[str, torch.Tensor],
    ref_points: np.ndarray,
) -> np.ndarray:
    """Evaluate ``fn(qp)`` at the given reference points of every cell.

    Returns a host array (n_cells, n_points, *fn_shape), squeezed over
    n_points = 1. ``fn`` receives the same QP context as energy
    integrands (grad_u, u, x, coefficients).
    """
    space = functional.space
    bs = space.bs
    ndof = space.element.ndof
    ref_points = np.atleast_2d(ref_points)
    nq = ref_points.shape[0]

    def tab(a):
        return torch.as_tensor(np.asarray(a), dtype=u.dtype, device=u.device)

    N_u = tab(space.element.tabulate(ref_points))
    dN_u = tab(space.element.tabulate_grad(ref_points))
    N_g = tab(functional.geom_element.tabulate(ref_points))
    dN_g = tab(functional.geom_element.tabulate_grad(ref_points))
    N_c = {
        c.name: tab(c.space.element.tabulate(ref_points))
        for c in functional.coefficients
    }
    coeff_bs = {c.name: c.space.bs for c in functional.coefficients}
    coeff_ndof = {
        c.name: c.space.element.ndof for c in functional.coefficients
    }

    u_cells = functional.gather(u)
    c_cells = functional.gather_coeffs(coeffs)
    x_cells = functional.x_cells.to(u.dtype)

    def per_cell(u_e, x_e, coeff_es):
        uu = u_e.reshape(ndof, bs)
        outs = []
        for q in range(nq):
            J = x_e.T @ dN_g[q]
            dN = dN_u[q] @ small_inv(J)
            grad_u = uu.T @ dN
            u_q = N_u[q] @ uu
            x_q = N_g[q] @ x_e
            cvals = {}
            for name, ce in coeff_es.items():
                cb = coeff_bs[name]
                cv = ce.reshape(coeff_ndof[name], cb)
                val = N_c[name][q] @ cv
                cvals[name] = val[0] if cb == 1 else val
            qp = QP(grad_u, u_q[0] if bs == 1 else u_q, x_q, cvals, {})
            outs.append(fn(qp))
        return torch.stack(outs)

    vals = vmap(per_cell, in_dims=(-1, -1, -1))(u_cells, x_cells, c_cells)
    out = vals.cpu().numpy()
    if nq == 1:
        out = out[:, 0]
    return out
