"""Small static matrices/vectors as Python containers of tensors.

``SMat``/``SVec`` keep the matrix STRUCTURE in Python and the entries as
separate tensors -- in the lane engine's reduced-variable physics every
entry is a flat ``(M,)`` tensor over all lane cells, so an integrand
written against the QP protocol (indexing + elementwise arithmetic, e.g.
forms.potentials.asym_damage_psi) runs as pure elementwise tensor ops
over the whole mesh with no per-cell ``vmap`` and no tiny (2, 2)
matrices on the device.
"""

from __future__ import annotations


def _binop(a, b, op):
    if isinstance(b, SMat):
        return [[op(x, y) for x, y in zip(ra, rb)]
                for ra, rb in zip(a, b.rows)]
    return [[op(x, b) for x in ra] for ra in a]


class SVec:
    __slots__ = ("items",)

    def __init__(self, items):
        self.items = list(items)

    def __getitem__(self, i):
        return self.items[i]

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        return iter(self.items)

    def __add__(self, o):
        if isinstance(o, SVec):
            return SVec([x + y for x, y in zip(self.items, o.items)])
        return SVec([x + o for x in self.items])

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, SVec):
            return SVec([x - y for x, y in zip(self.items, o.items)])
        return SVec([x - o for x in self.items])

    def __rsub__(self, o):
        return SVec([o - x for x in self.items])

    def __mul__(self, o):
        if isinstance(o, SVec):
            return SVec([x * y for x, y in zip(self.items, o.items)])
        return SVec([x * o for x in self.items])

    __rmul__ = __mul__

    def __truediv__(self, o):
        return SVec([x / o for x in self.items])

    def __neg__(self):
        return SVec([-x for x in self.items])

    def dot(self, o):
        acc = None
        for x, y in zip(self.items, o):
            t = x * y
            acc = t if acc is None else acc + t
        return acc


class SMat:
    __slots__ = ("rows",)

    def __init__(self, rows):
        self.rows = [list(r) for r in rows]

    @property
    def shape(self):
        return (len(self.rows), len(self.rows[0]))

    def __getitem__(self, ij):
        if isinstance(ij, tuple):
            i, j = ij
            return self.rows[i][j]
        return SVec(self.rows[ij])

    @property
    def T(self):
        return SMat(list(zip(*self.rows)))

    def __add__(self, o):
        import operator

        return SMat(_binop(self.rows, o, operator.add))

    __radd__ = __add__

    def __sub__(self, o):
        import operator

        return SMat(_binop(self.rows, o, operator.sub))

    def __mul__(self, o):
        import operator

        return SMat(_binop(self.rows, o, operator.mul))

    __rmul__ = __mul__

    def __truediv__(self, o):
        import operator

        return SMat(_binop(self.rows, o, operator.truediv))

    def __neg__(self):
        return SMat([[-x for x in r] for r in self.rows])

    def trace(self):
        acc = None
        for i in range(len(self.rows)):
            t = self.rows[i][i]
            acc = t if acc is None else acc + t
        return acc


# ---- polymorphic small-matrix helpers ---------------------------------------
# Potentials written against these work on BOTH paths: real tensors
# (flat Assembler, vmapped element kernels) and SMat containers (the
# lane engine's reduced physics). Structural loops unroll in Python;
# dims are 2 or 3.


def trace(A):
    if isinstance(A, SMat):
        return A.trace()
    import torch

    return torch.trace(A)


def matmul(A, B):
    """A @ B for SMat/SMat (structural) or tensors."""
    if isinstance(A, SMat) and isinstance(B, SMat):
        n, k = A.shape
        k2, m = B.shape
        rows = []
        for i in range(n):
            row = []
            for j in range(m):
                acc = None
                for l in range(k):
                    t = A.rows[i][l] * B.rows[l][j]
                    acc = t if acc is None else acc + t
                row.append(acc)
            rows.append(row)
        return SMat(rows)
    return A @ B


def det(A):
    """Closed-form 1x1/2x2/3x3 determinant (SMat or tensor)."""
    if isinstance(A, SMat):
        r = A.rows
        n = len(r)
        if n == 1:
            return r[0][0]
        if n == 2:
            return r[0][0] * r[1][1] - r[0][1] * r[1][0]
        if n == 3:
            return (
                r[0][0] * (r[1][1] * r[2][2] - r[1][2] * r[2][1])
                - r[0][1] * (r[1][0] * r[2][2] - r[1][2] * r[2][0])
                + r[0][2] * (r[1][0] * r[2][1] - r[1][1] * r[2][0])
            )
        raise NotImplementedError(f"det of {n}x{n} SMat")
    from tpufem_torch.elements.geometry import det as _det

    return _det(A)


def add_identity(A):
    """A + I without materializing an eye() (works for both kinds)."""
    if isinstance(A, SMat):
        rows = [list(r) for r in A.rows]
        for i in range(len(rows)):
            rows[i][i] = rows[i][i] + 1.0
        return SMat(rows)
    import torch

    n = A.shape[0]
    return A + torch.eye(n, dtype=A.dtype, device=A.device)
