"""mechanic2d -- pieces of the reference study's workload that the
polycrystal case shares: the per-grain Young's modulus stream, the
volumetric load and the DG0 strain/stress postprocess.

Mirrors ``FEniCSx/mechanic2d/asym_elasto_damage_model.cc`` (material at
:532-542, load at :563-585, DG0 expressions interpolated at :909-941);
physics definitions from ``asym_ufl.py``. The full gmsh-driven workload
(``setup``/``run``) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import grad, vmap

from tpufem_torch.assemble.assembler import Assembler, _map_cell_slabs
from tpufem_torch.elements.geometry import inv as small_inv
from tpufem_torch.elements.quadrature import quadrature
from tpufem_torch.forms.potentials import asym_damage_psi
from tpufem_torch.utils import GlibcRand

NU = 0.3  # Poisson ratio (FEniCSx/...cc:254)


def young_modulus_range(use_ecst: bool = False) -> np.ndarray:
    """200 semi-random E values in [5e6, 1e8] keyed by physical tag,
    glibc srand(6575) -- bit-identical to FEniCSx/...cc:532-542."""
    rng = GlibcRand(6575)
    a = (1.0e8 - 5.0e6) / 199.0
    vals = np.array([a * (rng.rand() % 200) + 5.0e6 for _ in range(200)])
    if use_ecst:
        vals[:] = 1.0e6
    return vals


def volumetric_load(x: np.ndarray) -> np.ndarray:
    """f = ((1600 (y-.5)^2 - 500)*(-100000 (x-.5)^3), 0)
    (doc.tex:226-232; FEniCSx/...cc:563-585)."""
    r = x[:, 0] - 0.5
    y = x[:, 1] - 0.5
    fx = (1600.0 * y * y - 500.0) * (-100000.0 * r * r * r)
    return np.stack([fx, np.zeros_like(fx)], axis=1)


def postprocess(asm: Assembler, u: torch.Tensor, coeffs,
                batch: Optional[int] = None):
    """Centroid strain/stress/energy per cell as reduced vectors
    [t11, t12, t22] -- the reference's three DG0 expressions
    (asym_ufl.py:86-97, interpolated at FEniCSx/...cc:909-941).

    ``batch``: evaluate in cell slabs of this size so the kernel's
    temporaries stay bounded at multi-million-cell meshes (same contract
    as Assembler.residual's ``batch``). Returns NumPy arrays
    (nc, 3), (nc, 3), (nc,)."""
    func = asm.functional
    V = func.space
    u_cells = func.gather(u)
    c_cells = func.gather_coeffs(coeffs)

    qpts, _ = quadrature(V.mesh.cell_type, 1)  # centroid for P1 triangles
    dN_ref = torch.as_tensor(V.element.tabulate_grad(qpts)[0],
                             dtype=u.dtype, device=u.device)  # (ndof, dim)
    dNg_ref = torch.as_tensor(func.geom_element.tabulate_grad(qpts)[0],
                              dtype=u.dtype, device=u.device)

    def per_cell(u_e, x_e, d_e, E_e):
        J = x_e.T @ dNg_ref
        dN = dN_ref @ small_inv(J)
        grad_u = u_e.reshape(-1, 2).T @ dN
        eps = 0.5 * (grad_u + grad_u.T)
        d_c = torch.mean(d_e)  # P1 value at centroid = mean of vertices
        sig = grad(lambda e: asym_damage_psi(e, d_c, E_e[0], NU))(eps)
        sig = 0.5 * (sig + sig.T)
        energy = torch.sum(eps * sig)
        return (
            torch.stack([eps[0, 0], eps[0, 1], eps[1, 1]]),
            torch.stack([sig[0, 0], sig[0, 1], sig[1, 1]]),
            energy,
        )

    kernel = vmap(per_cell, in_dims=(-1, -1, -1, -1), out_dims=(-1, -1, -1))
    args = (u_cells, func.x_cells.to(u.dtype), c_cells["d"], c_cells["E"])
    if batch and u_cells.shape[-1] > batch:
        strain, stress, energy = _map_cell_slabs(
            lambda a: kernel(*a), args, batch
        )
    else:
        strain, stress, energy = kernel(*args)
    return (strain.T.cpu().numpy(), stress.T.cpu().numpy(),
            energy.cpu().numpy())
