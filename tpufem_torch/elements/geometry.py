"""Closed-form small-matrix geometry kernels.

Reference->physical maps only need 1x1/2x2/3x3 determinants and
inverses, so they are expanded in closed form (exactly what ffcx emits
into its generated kernels for the affine Jacobian): elementwise tensor
arithmetic that batches and differentiates cleanly, with no LU call per
cell.
"""

from __future__ import annotations

import torch


def det(J):
    """Determinant of a (d, d) matrix, d ∈ {1, 2, 3}, closed form."""
    d = J.shape[-1]
    if d == 1:
        return J[..., 0, 0]
    if d == 2:
        return J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    if d == 3:
        return (
            J[..., 0, 0] * (J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1])
            - J[..., 0, 1] * (J[..., 1, 0] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 0])
            + J[..., 0, 2] * (J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0])
        )
    raise NotImplementedError(f"det for d={d}")


def inv(J):
    """Inverse of a (d, d) matrix, d ∈ {1, 2, 3}, closed form (adjugate)."""
    d = J.shape[-1]
    if d == 1:
        return 1.0 / J
    dt = det(J)
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        adj = torch.stack(
            [torch.stack([e, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2
        )
        return adj / dt[..., None, None]
    if d == 3:
        a00, a01, a02 = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
        a10, a11, a12 = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
        a20, a21, a22 = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
        c00 = a11 * a22 - a12 * a21
        c01 = a02 * a21 - a01 * a22
        c02 = a01 * a12 - a02 * a11
        c10 = a12 * a20 - a10 * a22
        c11 = a00 * a22 - a02 * a20
        c12 = a02 * a10 - a00 * a12
        c20 = a10 * a21 - a11 * a20
        c21 = a01 * a20 - a00 * a21
        c22 = a00 * a11 - a01 * a10
        adj = torch.stack(
            [
                torch.stack([c00, c01, c02], dim=-1),
                torch.stack([c10, c11, c12], dim=-1),
                torch.stack([c20, c21, c22], dim=-1),
            ],
            dim=-2,
        )
        return adj / dt[..., None, None]
    raise NotImplementedError(f"inv for d={d}")
