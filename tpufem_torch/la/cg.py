"""Preconditioned conjugate gradients with the reference's stopping rule.

Mirrors the reference's KSP CG configuration: rtol 1e-12, max 2000
iterations (FEniCSx/mechanic2d/asym_elasto_damage_model.cc:718) /
mfem::CGSolver (MFEM/...cc:1502, 1525-1528), and ``tpufem.la.cg``: stop
at the first k with |r_k|^2 <= max(rtol |b|, atol)^2, or at ``maxit``.

The reference runs the loop as one ``lax.while_loop`` whose condition
stays on the device. Here the iterations are enqueued in chunks of
``chunk`` with no host read inside a chunk: the test runs on the device
every iteration, and once it holds, the step coefficients become
(alpha, beta) = (0, 1), which leaves x, r, z and p as they are and stops
the counter. The host reads the counter once a chunk, so the exit
iteration and the iterate are those of the unchunked loop (``chunk=1``)
whatever ``chunk`` is; a chunk costs at most ``chunk - 1`` frozen
iterations at the end of a solve.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

CG_CHUNK = 50  # iterations enqueued between two host reads


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual_norm: float
    converged: bool


def pcg_chunk(A, M, dot, nsteps, state, tol2):
    """``nsteps`` preconditioned CG iterations under the inner product
    ``dot``, all enqueued without a host read. Once rr <= tol2 the step
    coefficients become (alpha, beta) = (0, 1), which leaves x, r, z and
    p bitwise unchanged and stops the counter. The lane engine's CG runs
    its chunks through this function too."""
    x, r, z, p, rz, rr, k = state
    zero = torch.zeros_like(rz)
    one = torch.ones_like(rz)
    for _ in range(nsteps):
        active = rr > tol2
        Ap = A(p)
        alpha = torch.where(active, rz / dot(p, Ap), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        beta = torch.where(active, rz_new / rz, one)
        p = torch.where(active, one, zero) * z + beta * p
        rz = torch.where(active, rz_new, rz)
        rr = torch.where(active, dot(r, r), rr)
        k = k + active
    return (x, r, z, p, rz, rr, k)


def cg(
    A: Callable,
    b: torch.Tensor,
    *,
    M: Optional[Callable] = None,
    rtol: float = 1.0e-12,
    atol: float = 0.0,
    maxit: int = 2000,
    chunk: int = CG_CHUNK,
) -> CGResult:
    """Solve A x = b with (preconditioned) CG from x = 0.

    ``A`` and ``M`` are linear maps (callables). The loop starts from
    r = b (A(0) is not applied: it is exactly 0).
    """
    if M is None:
        M = lambda v: v
    dot = torch.dot
    z0 = M(b)
    # PETSc-style: relative to ||b||, on the device like the reference
    tol2 = torch.clamp(rtol * torch.sqrt(dot(b, b)), min=atol) ** 2
    state = (torch.zeros_like(b), b, z0, z0, dot(b, z0), dot(b, b),
             torch.zeros((), dtype=torch.int64, device=b.device))
    k = 0
    while k < maxit:
        nsteps = min(chunk, maxit - k)
        state = pcg_chunk(A, M, dot, nsteps, state, tol2)
        kd = int(state[6]) - k  # blocks on the device
        k += kd
        if kd < nsteps or not bool(state[5] > tol2):
            break
    rr = math.sqrt(float(dot(state[1], state[1])))
    return CGResult(x=state[0], iters=k, residual_norm=rr,
                    converged=rr * rr <= float(tol2))
