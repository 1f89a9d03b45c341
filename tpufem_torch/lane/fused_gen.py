"""Element physics of the fused kernel generated from the elementwise
energy: the tracer and the emitter of the generated K4 route.

The reference traces the AD graph of any elementwise integrand into its
Pallas kernel (``tpufem/lane/engine.py:1109-1245``, ``_make_block_fns`` /
``_tile_ad_fns``). The port does the same ahead of time. On the P1
single-point path the cell energy is a function of the reduced variables
of the staged path (``LaneEngine._make_reduced_fns``): the ``bs * gd``
gradient components, then the ``bs`` value components, with the
quadrature weight ``w``, the ``gd`` quadrature-point coordinates and the
averaged coefficient components as further inputs. ``make_fx`` traces,
on 0-dim tensors of the engine's dtype, two graphs of elementwise aten
operations:

- ``grad``: the gradient of ``integrand(qp) * w`` in the reduced
  variables (inputs: the reduced variables, ``w``, ``x``, coefficients);
- ``jvp``: the directional derivative of that gradient along a reduced
  direction (the same inputs, then the direction).

Each graph is normalized (aliases, expands, same-dtype copies and the
autograd checks dropped, constants made ``full_like`` of the first input,
dead code removed) and then serves twice:

- as a ``GraphModule`` run on (..., K, 128) tensors, the plain version of
  the generated kernel (:meth:`GenPhysics.elem_vectors`);
- emitted as straight-line C, one statement per node in graph order
  (:meth:`GenPhysics.c_struct`), and ``#include``d into the kernel
  template ``csrc/lane_fused_gen.cuh``.

The emitter knows what PyTorch's CUDA kernels compute for each operation,
so that the kernel is bit for bit the plain version on the card: a
division by a Python number is a product with its reciprocal rounded in
the working type, and ``pow`` with the exponents 2, 3, -2, 0.5, -0.5 and -1
takes PyTorch's special forms. Operations outside the list raise
``NotImplementedError`` naming the operation; nothing falls back to
another path.

The quadrature-point rows of the kernel's geometry are streamed only
where an ``x`` input of either graph has a user after dead-code
elimination -- what the reference decides with a poison probe.

:class:`GenPhysicsMQ` is the multi-quadrature-point variant (P2, Q1, Q2,
P1 under a higher rule, folded terms; the reference's
``_make_block_fns_mq``, ``tpufem/lane/engine.py:1247-1329``). The traced
graphs are the same -- the integrand at one point is a function of that
point's reduced variables, weight, coordinates and coefficient
components -- and what changes is around them: the reduced variables and
the coefficient components at each point go through the element's basis
values ``Nf`` / ``Nc`` (zero weights skipped, unit weights not
multiplied), and the chain back sums the points in order. Its kernel
template is ``csrc/lane_fused_gen_mq.cuh``.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.fx as fx

from tpufem_torch.forms.form import QP
from tpufem_torch.forms.smat import SMat, SVec

aten = torch.ops.aten
prims = torch.ops.prims

ROADMAP_ITEM = "ROADMAP.md Q1 item 6.5a: K4, kernel source generated from " \
               "the elementwise energy"

# node targets that compute nothing: their result is their first argument
_IDENTITY = {aten.alias.default, aten.expand.default, aten.detach.default,
             aten.view.default, aten.clone.default}
# autograd's shape checks: no value, no user
_CHECKS = {aten.is_same_size.default, aten._has_same_storage_numel.default}
# constants: (target, how its value is read from the node)
_CONSTANTS = {
    aten.ones_like.default: lambda n: 1.0,
    aten.zeros_like.default: lambda n: 0.0,
    aten.zeros.default: lambda n: 0.0,
    aten._efficientzerotensor.default: lambda n: 0.0,
    aten.scalar_tensor.default: lambda n: float(n.args[0]),
    aten.full_like.default: lambda n: float(n.args[1]),
    aten.full.default: lambda n: float(n.args[1]),
}
_BINARY = {
    aten.add.Tensor: "+", aten.sub.Tensor: "-", aten.mul.Tensor: "*",
    aten.div.Tensor: "/", aten.mul.Scalar: "*", aten.add.Scalar: "+",
    aten.sub.Scalar: "-", aten.div.Scalar: "/",
    prims.add.default: "+", prims.mul.default: "*",
    prims.sub.default: "-", prims.div.default: "/",
}
_COMPARE = {
    aten.lt.Scalar: "<", aten.le.Scalar: "<=", aten.gt.Scalar: ">",
    aten.ge.Scalar: ">=", aten.eq.Scalar: "==", aten.ne.Scalar: "!=",
    aten.lt.Tensor: "<", aten.le.Tensor: "<=", aten.gt.Tensor: ">",
    aten.ge.Tensor: ">=", aten.eq.Tensor: "==", aten.ne.Tensor: "!=",
}
_UNARY = {aten.neg.default, aten.sqrt.default, aten.log.default,
          aten.reciprocal.default}
# the normalized graph's own target for each binary operator
_BINARY_ATEN = {"+": aten.add.Tensor, "-": aten.sub.Tensor,
                "*": aten.mul.Tensor, "/": aten.div.Tensor}


def _unsupported(what: str):
    return NotImplementedError(
        f"fused element kernel: {what} has no C form in the generated "
        f"kernel ({ROADMAP_ITEM}); the staged engine (fused=False) runs "
        "this integrand")


def _val(n):
    return n.meta.get("val") if isinstance(n, fx.Node) else None


def normalize(gm: fx.GraphModule, dtype: torch.dtype) -> fx.GraphModule:
    """A copy of the traced graph ``gm`` with only the operations the
    emitter knows: no-op nodes replaced by their input, checks removed,
    constants as ``full_like`` of the first input (so that the module runs
    on batched inputs of any device), ``rsub`` as a subtraction, prims as
    aten, dead code removed. Raises ``NotImplementedError`` for any other
    operation, for an ``add`` / ``sub`` with ``alpha``, and for a value of
    another floating type than ``dtype``."""
    src = gm.graph
    for n in list(src.nodes):
        if n.op == "call_function" and n.target in _CHECKS:
            src.erase_node(n)
    src.eliminate_dead_code()
    g = fx.Graph()
    env: Dict[fx.Node, object] = {}
    first = None

    def arg(a):
        return env[a] if isinstance(a, fx.Node) else a

    for n in src.nodes:
        if n.op == "placeholder":
            env[n] = g.placeholder(n.name)
            first = first if first is not None else env[n]
            continue
        if n.op == "output":
            outs = n.args[0]
            g.output(tuple(arg(o) for o in outs) if isinstance(
                outs, (tuple, list)) else arg(outs))
            continue
        if n.op != "call_function":
            raise _unsupported(f"graph node {n.op} {n.target}")
        t = n.target
        v = _val(n)
        if isinstance(v, torch.Tensor) and v.dtype not in (dtype, torch.bool):
            raise _unsupported(f"a {v.dtype} value ({t}) in a {dtype} graph")
        if t in _IDENTITY:
            env[n] = arg(n.args[0])
        elif t is aten._to_copy.default:
            src_v = _val(n.args[0])
            if src_v is None or v is None:
                raise _unsupported(f"{t} of an unknown type")
            if src_v.dtype == v.dtype:
                env[n] = arg(n.args[0])
            elif src_v.dtype == torch.bool:
                env[n] = g.call_function(aten._to_copy.default,
                                         (arg(n.args[0]),),
                                         {"dtype": dtype})
            else:
                raise _unsupported(f"a cast from {src_v.dtype} to {v.dtype}")
        elif t in _CONSTANTS:
            env[n] = g.call_function(aten.full_like.default,
                                     (first, _CONSTANTS[t](n)))
        elif t in _BINARY:
            if n.kwargs.get("alpha", 1) != 1 or "rounding_mode" in n.kwargs:
                raise _unsupported(f"{t} with {dict(n.kwargs)}")
            env[n] = g.call_function(_BINARY_ATEN[_BINARY[t]],
                                     tuple(arg(a) for a in n.args[:2]))
        elif t is aten.rsub.Scalar:
            if n.kwargs.get("alpha", 1) != 1:
                raise _unsupported(f"{t} with {dict(n.kwargs)}")
            env[n] = g.call_function(aten.rsub.Scalar,
                                     (arg(n.args[0]), n.args[1]))
        elif t in _COMPARE or t in _UNARY or t is aten.where.self:
            env[n] = g.call_function(t, tuple(arg(a) for a in n.args))
        elif t is aten.pow.Tensor_Scalar:
            if not isinstance(n.args[1], (int, float)):
                raise _unsupported(f"{t} with exponent {n.args[1]!r}")
            env[n] = g.call_function(t, (arg(n.args[0]), n.args[1]))
        elif t in (aten.clamp.default, aten.clamp_min.default,
                   aten.clamp_max.default):
            lo = n.args[1] if len(n.args) > 1 else n.kwargs.get("min")
            hi = n.args[2] if len(n.args) > 2 else n.kwargs.get("max")
            if t is aten.clamp_max.default:
                lo, hi = None, n.args[1]
            if any(isinstance(b, fx.Node) for b in (lo, hi)):
                raise _unsupported(f"{t} with a tensor bound")
            env[n] = g.call_function(aten.clamp.default,
                                     (arg(n.args[0]), lo, hi))
        else:
            raise _unsupported(f"the operation {t}")
    g.eliminate_dead_code()
    return fx.GraphModule(torch.nn.Module(), g)


def histogram(gm: fx.GraphModule) -> Dict[str, int]:
    """Operation counts of a graph (its call nodes by target name)."""
    return dict(collections.Counter(
        str(n.target) for n in gm.graph.nodes if n.op == "call_function"))


def _lit(x: float, dtype: torch.dtype) -> str:
    """A C literal of ``x`` rounded to ``dtype``: hex float, exact."""
    if dtype == torch.float32:
        v = float(np.float32(x))
        suffix = "f"
    else:
        v = float(x)
        suffix = ""
    if math.isnan(v):
        raise _unsupported("a NaN constant")
    if math.isinf(v):
        return ("-" if v < 0 else "") + "(GT)INFINITY"
    return "(" + v.hex() + suffix + ")"


def _reciprocal(x: float, dtype: torch.dtype) -> float:
    """1 / x as PyTorch's CUDA division by a CPU scalar takes it: the
    reciprocal in float64, rounded to the working type (the product is
    then taken in the working type). On the card, ``t / 0.52`` in float32
    is ``t * float32(1 / 0.52)``, not ``t * (1 / float32(0.52))``: the two
    constants differ in the last bit, and so did 74 % of the products
    (H100, torch 2.11)."""
    return float(np.asarray(1.0 / float(x)).astype(
        np.float32 if dtype == torch.float32 else np.float64))


def emit(gm: fx.GraphModule, inputs: Sequence[str], out: str,
         dtype: torch.dtype, target: str) -> List[str]:
    """C statements of the normalized graph ``gm`` in graph order: its
    placeholders read ``inputs`` (C expressions), its outputs are stored
    to ``out[i]``. ``target``: ``"cuda"`` spells each operation as
    PyTorch's CUDA kernel computes it, ``"host"`` as its CPU kernel does
    (for holding the emitted code against the graph on the CPU)."""
    if target not in ("cuda", "host"):
        raise ValueError(f"target {target!r}")
    f32 = dtype == torch.float32
    fn = {k: (k + "f" if f32 and target == "cuda" else k)
          for k in ("sqrt", "log", "pow", "fmax", "fmin", "rsqrt")}
    if target == "host":
        fn.update(sqrt="std::sqrt", log="std::log", pow="std::pow",
                  fmax="std::fmax", fmin="std::fmin")
    lines, name = [], {}
    ph = iter(inputs)

    def a(x):
        if isinstance(x, fx.Node):
            return name[x]
        if isinstance(x, bool) or not isinstance(x, (int, float)):
            raise _unsupported(f"the argument {x!r}")
        return _lit(float(x), dtype)

    def bind(n, expr, typ="GT"):
        name[n] = f"v{len(name)}"
        lines.append(f"const {typ} {name[n]} = {expr};")

    for n in gm.graph.nodes:
        t = n.target
        if n.op == "placeholder":
            name[n] = next(ph)
        elif n.op == "output":
            outs = n.args[0] if isinstance(n.args[0], tuple) else (n.args[0],)
            for i, o in enumerate(outs):
                lines.append(f"{out}[{i}] = {a(o)};")
        elif t is aten.full_like.default:
            bind(n, _lit(float(n.args[1]), dtype))
        elif t is aten._to_copy.default:
            bind(n, f"(GT)({a(n.args[0])})")
        elif t in (aten.add.Tensor, aten.sub.Tensor, aten.mul.Tensor):
            op = {aten.add.Tensor: "+", aten.sub.Tensor: "-",
                  aten.mul.Tensor: "*"}[t]
            bind(n, f"{a(n.args[0])} {op} {a(n.args[1])}")
        elif t is aten.div.Tensor:
            x, y = n.args
            if not isinstance(x, fx.Node):
                raise _unsupported("a division of a number by a tensor")
            if isinstance(y, fx.Node) or target == "host":
                bind(n, f"{a(x)} / {a(y)}")
            else:  # CUDA: a product with the reciprocal of the scalar
                bind(n, f"{a(x)} * {_lit(_reciprocal(y, dtype), dtype)}")
        elif t is aten.rsub.Scalar:
            bind(n, f"{a(n.args[1])} - {a(n.args[0])}")
        elif t is aten.neg.default:
            bind(n, f"-{a(n.args[0])}")
        elif t is aten.sqrt.default:
            bind(n, f"{fn['sqrt']}({a(n.args[0])})")
        elif t is aten.log.default:
            bind(n, f"{fn['log']}({a(n.args[0])})")
        elif t is aten.reciprocal.default:
            bind(n, f"(GT)1 / {a(n.args[0])}")
        elif t in _COMPARE:
            bind(n, f"{a(n.args[0])} {_COMPARE[t]} {a(n.args[1])}", "bool")
        elif t is aten.where.self:
            c, x, y = (a(z) for z in n.args)
            bind(n, f"{c} ? {x} : {y}")
        elif t is aten.clamp.default:
            x, lo, hi = n.args
            e = a(x)
            if lo is not None:
                e = f"{fn['fmax']}({e}, {a(lo)})"
            if hi is not None:
                e = f"{fn['fmin']}({e}, {a(hi)})"
            nan = "isnan" if target == "cuda" else "std::isnan"
            bind(n, f"{nan}({a(x)}) ? {a(x)} : {e}")
        elif t is aten.pow.Tensor_Scalar:
            bind(n, _pow(a(n.args[0]), float(n.args[1]), dtype, target, fn))
        else:
            raise _unsupported(f"the operation {t}")
    return lines


def _pow(x: str, e: float, dtype, target, fn) -> str:
    """``pow(x, e)`` as PyTorch computes it: 0 and 1 in ``pow`` itself,
    0.5 / -0.5 / -1 as sqrt / rsqrt / reciprocal, 2 / 3 / -2 as products,
    anything else by the math library's ``pow``."""
    if e == 0.0:
        return _lit(1.0, dtype)
    if e == 1.0:
        return x
    if e == 0.5:
        return f"{fn['sqrt']}({x})"
    if e == -0.5:
        if target == "cuda":
            return f"{fn['rsqrt']}({x})"
        return f"(GT)1 / {fn['sqrt']}({x})"
    if e == -1.0:
        return f"(GT)1 / {x}"
    if e == 2.0:
        return f"{x} * {x}"
    if e == 3.0:
        return f"{x} * {x} * {x}"
    if e == -2.0:
        if target == "cuda":  # 1.0 / (base * base): a double division
            return f"(GT)(1.0 / (double)({x} * {x}))"
        return f"(GT)1 / ({x} * {x})"
    return f"{fn['pow']}({x}, {_lit(e, dtype)})"


class GenPhysics:
    """The generated element physics of one P1 single-point integrand at
    one dtype: the traced graphs, their plain evaluation and their C form.

    ``coeff_meta``: ``(name, dofs a cell, components)`` of each coefficient
    in the order of the functional (its rows in the coefficient block:
    dof-major, component inner)."""

    MULTIQP = False  # lane.kernels.lane_fused_gen dispatches on it

    def __init__(self, integrand, *, bs: int, gd: int, nv: int,
                 coeff_meta: Sequence[Tuple[str, int, int]],
                 dtype: torch.dtype):
        from torch.func import jvp, vjp
        from torch.fx.experimental.proxy_tensor import make_fx

        self.bs, self.gd, self.nv, self.dtype = bs, gd, nv, dtype
        self.coeff_meta = tuple(coeff_meta)
        self.nG = bs * gd
        self.nR = self.nG + bs
        self.n_comp = sum(cb for _, _, cb in coeff_meta)
        self.n_coeff_rows = sum(n * cb for _, n, cb in coeff_meta)
        self.n_in = self.nR + 1 + gd + self.n_comp
        nR, nG = self.nR, self.nG

        def cell_energy(*a):
            grad_u = SMat([[a[c * gd + d] for d in range(gd)]
                           for c in range(bs)])
            uq = a[nG] if bs == 1 else SVec(a[nG:nR])
            x = SVec(a[nR + 1:nR + 1 + gd])
            cvals, o = {}, nR + 1 + gd
            for nm, _, cb in coeff_meta:
                cvals[nm] = a[o] if cb == 1 else SVec(a[o:o + cb])
                o += cb
            return integrand(QP(grad_u, uq, x, cvals, {})) * a[nR]

        # one-element tensors, not 0-dim ones: a Python number's tangent
        # would otherwise be promoted to float64 in forward mode (0-dim
        # against 0-dim); the gradient is pulled back with a cotangent of
        # ones, as the reference does (tpufem/lane/engine.py:1215)
        def grad_fn(*a):
            rest = a[nR:]
            out, pull = vjp(lambda *r: cell_energy(*r, *rest), *a[:nR])
            return pull(torch.ones_like(out))

        def jvp_fn(*a):
            rest = a[nR:self.n_in]
            return jvp(lambda *r: grad_fn(*r, *rest), tuple(a[:nR]),
                       tuple(a[self.n_in:]))[1]

        probe = [torch.full((1,), 0.01 * (i + 1), dtype=dtype)
                 for i in range(self.n_in + nR)]
        # fake tensors: no arithmetic runs, and a Python branch on a value
        # raises instead of baking one side into the graph
        self.grad_gm = normalize(make_fx(grad_fn, tracing_mode="fake")(
            *probe[:self.n_in]), dtype)
        self.jvp_gm = normalize(make_fx(jvp_fn, tracing_mode="fake")(*probe),
                                dtype)
        for gm, n in ((self.grad_gm, nR), (self.jvp_gm, nR)):
            outs = next(iter(reversed(gm.graph.nodes))).args[0]
            if not isinstance(outs, tuple) or len(outs) != n:
                raise _unsupported("an energy that is not a scalar of the "
                                   "quadrature point")
        # the x rows are streamed where an x input has a user
        x_names = set()
        for gm in (self.grad_gm, self.jvp_gm):
            phs = [n for n in gm.graph.nodes if n.op == "placeholder"]
            x_names |= {p.name for p in phs[nR + 1:nR + 1 + gd] if p.users}
        self.x_rows = bool(x_names)
        self.dg = nv * gd + 1 + (gd if self.x_rows else 0)
        self.inv_nv = 1.0 / nv
        self.rcp = {n: _reciprocal(n, dtype) for _, n, _ in coeff_meta
                    if n > 1}
        self._c_cuda = None  # the CUDA form of the physics, at first use
        # the loaded units of this physics (lane.kernels.lane_fused_gen),
        # by index type and block layouts: no source or digest a launch
        self.units = {}

    # -- the plain version --------------------------------------------------

    def histogram(self) -> Dict[str, Dict[str, int]]:
        return dict(grad=histogram(self.grad_gm), jvp=histogram(self.jvp_gm))

    def ops_per_cell(self, n_states: int) -> int:
        """Floating-point operations of one cell's element vector: the
        graph's arithmetic nodes (a constant, a cast, a comparison or a
        selection counts none), the reduced variables of each state and the
        chain back to the dof rows."""
        gm = self.grad_gm if n_states == 1 else self.jvp_gm
        free = {aten.full_like.default, aten._to_copy.default,
                aten.where.self, *_COMPARE}
        graph = sum(1 for n in gm.graph.nodes
                    if n.op == "call_function" and n.target not in free)
        reduced = self.bs * (self.gd * (2 * self.nv - 1) + self.nv)
        chain = self.nv * self.bs * (1 + 2 * self.gd)
        return graph + n_states * reduced + chain

    def reduced(self, u, dN):
        """The reduced variables of dof rows ``u`` (row v*bs+c): gradient
        components, then values, separate multiplies and adds."""
        bs, gd, nv = self.bs, self.gd, self.nv
        a = []
        for c in range(bs):
            for d in range(gd):
                acc = u[c] * dN[0][d]
                for v in range(1, nv):
                    acc = acc + u[v * bs + c] * dN[v][d]
                a.append(acc)
        for c in range(bs):
            acc = u[c]
            for v in range(1, nv):
                acc = acc + u[v * bs + c]
            a.append(acc * self.inv_nv)
        return a

    def coeff_inputs(self, cd):
        """The averaged coefficient components from the rows ``cd``."""
        comps, off = [], 0
        for _, n, cb in self.coeff_meta:
            for j in range(cb):
                acc = cd[off + j]
                for i in range(1, n):
                    acc = acc + cd[off + i * cb + j]
                comps.append(acc if n == 1 else acc * self.rcp[n])
            off += n * cb
        return comps

    def elem_vectors(self, u_blocks, cds):
        """The element gradient (one state) or Hessian-vector product
        (two) on tensors: ``u_blocks`` one or two (nv*bs, ...) dof blocks,
        ``cds`` = (geometry rows (dg, ...), [coefficient rows (Dc, ...)]).
        Returns (nv*bs, ...) -- what the kernel computes, in its order."""
        bs, gd, nv, nG = self.bs, self.gd, self.nv, self.nG
        geom = cds[0]
        dN = [[geom[v * gd + d] for d in range(gd)] for v in range(nv)]
        w = geom[nv * gd]
        x = ([geom[nv * gd + 1 + d] for d in range(gd)] if self.x_rows
             else [torch.zeros_like(w)] * gd)
        cin = self.coeff_inputs(cds[1]) if self.n_comp else []
        ins = [*self.reduced(u_blocks[0], dN), w, *x, *cin]
        if len(u_blocks) == 1:
            g = self.grad_gm(*ins)
        else:
            g = self.jvp_gm(*ins, *self.reduced(u_blocks[1], dN))
        rows = []
        for v in range(nv):
            for c in range(bs):
                acc = g[nG + c] * self.inv_nv
                for d in range(gd):
                    acc = acc + g[c * gd + d] * dN[v][d]
                rows.append(acc)
        return torch.stack(rows)

    # -- the C form ----------------------------------------------------------

    def c_struct(self, target: str = "cuda", name: str = "GenPhys") -> str:
        """The physics as a C++ struct for ``csrc/lane_fused_gen.cuh``:
        its sizes and three functions, ``coeffs`` (staged coefficient
        rows, row stride ``rs`` -> averaged components), ``grad`` and
        ``jvp`` (inputs ``in``: reduced variables, w, x, components;
        ``din``: a reduced direction; outputs the reduced gradient)."""
        dt = self.dtype
        ctype = "float" if dt == torch.float32 else "double"
        nR, gd = self.nR, self.gd
        ins = [f"in[{i}]" for i in range(self.n_in)]
        cl, off, k = [], 0, 0
        for _, n, cb in self.coeff_meta:
            for j in range(cb):
                terms = [f"rows[{off + i * cb + j} * rs]" for i in range(n)]
                e = terms[0]
                for t in terms[1:]:
                    e = f"({e} + {t})"
                if n > 1:
                    e = f"{e} * {_lit(self.rcp[n], dt)}"
                cl.append(f"cin[{k}] = {e};")
                k += 1
            off += n * cb
        body = {
            "grad": emit(self.grad_gm, ins, "out", dt, target),
            "jvp": emit(self.jvp_gm, ins + [f"din[{i}]" for i in range(nR)],
                        "out", dt, target),
        }

        def block(lines):
            return "\n".join("    " + s for s in lines)

        return f"""struct {name} {{
  typedef {ctype} GT;
  static constexpr int NV = {self.nv}, C = {self.bs}, GD = {gd};
  static constexpr int XR = {int(self.x_rows)}, DG = {self.dg};
  static constexpr int DC = {self.n_coeff_rows}, NCOMP = {self.n_comp};
  static constexpr int NR = {nR}, NIN = {self.n_in};
  static constexpr GT INV_NV = {_lit(self.inv_nv, dt)};
  GEN_HD static void coeffs(const GT* __restrict__ rows, int rs,
                            GT* __restrict__ cin) {{
    (void)rows; (void)rs; (void)cin;
{block(cl)}
  }}
  GEN_HD static void grad(const GT* __restrict__ in, GT* __restrict__ out) {{
{block(body['grad'])}
  }}
  GEN_HD static void jvp(const GT* __restrict__ in,
                         const GT* __restrict__ din, GT* __restrict__ out) {{
    (void)din;
{block(body['jvp'])}
  }}
}};
"""

    def cuda_source(self, itype: torch.dtype,
                    layouts: Tuple[Tuple[int, int, int, bool], ...]) -> str:
        """The CUDA unit of the physics for index type ``itype``: the
        launchers ``lane_fused_gen_launch1`` (gradient) and ``..._launch2``
        (Hessian-vector product) of csrc/lane_fused_gen.cuh, each with its
        block layout ``(lb, ky, stages, window staged)`` of ``layouts``."""
        if self._c_cuda is None:
            self._c_cuda = self.c_struct("cuda")
        ity = {torch.int8: "int8_t", torch.int32: "int32_t"}[itype]
        entries = "\n".join(
            f"LANE_FUSED_GEN_ENTRY(GenPhys, {ity}, {ns}, {lb}, {ky}, "
            f"{stages}, {str(bool(win)).lower()})"
            for ns, (lb, ky, stages, win) in enumerate(layouts, start=1))
        return f"""// generated: the element physics of one integrand, traced
// (tpufem_torch/lane/fused_gen.py), in the fused kernel's template
#include "lane_fused_gen.cuh"
{self._c_cuda}
{entries}
"""


class GenPhysicsMQ(GenPhysics):
    """The generated element physics of one multi-quadrature-point
    integrand at one dtype (the cell terms folded into one, ``lane.multiqp
    .fold_terms``): the point graphs of :class:`GenPhysics` and the
    element's basis values at the points, ``Nf`` (nq, nv) and, per nodal
    coefficient, ``Nc[name]`` (nq, dofs a cell; None for a P0 coefficient,
    whose one value is used as it is), both rounded to ``dtype``.

    Geometry rows of a cell (the reference's ``fused_geom``): dN at row
    (q * nv + v) * gd + d, then the nq weights, then, where the graphs read
    x, the nq * gd quadrature-point rows (q * gd + d). At point q:

    - ``a[c*gd+d] = sum_v u[v*bs+c] * dN[q][v][d]`` (v ascending, the
      first product starting the sum), ``a[nG+c] = sum_v Nf[q,v] *
      u[v*bs+c]`` and the coefficient components ``sum_i Nc[q,i] *
      cd[i*cb+j]``, zero weights skipped and unit weights not multiplied;
    - the graph's gradient ``g`` at the point;
    - ``e[v*bs+c] = sum_d g[c*gd+d] * dN[q][v][d] (+ Nf[q,v] * g[nG+c])``,
      added to the element vector, points in order (the first point's
      ``e`` starts it)."""

    MULTIQP = True

    def __init__(self, integrand, *, bs: int, gd: int, nv: int,
                 coeff_meta: Sequence[Tuple[str, int, int]],
                 dtype: torch.dtype, Nf: np.ndarray,
                 Nc: Dict[str, np.ndarray]):
        super().__init__(integrand, bs=bs, gd=gd, nv=nv,
                         coeff_meta=coeff_meta, dtype=dtype)
        work = np.float32 if dtype == torch.float32 else np.float64
        Nf = np.asarray(Nf, np.float64)
        if Nf.ndim != 2 or Nf.shape[1] != nv:
            raise ValueError(f"Nf of shape {Nf.shape}, expected (nq, {nv})")
        self.nq = Nf.shape[0]
        # the tables' values in the working type, as Python floats
        self.Nf = Nf.astype(work).astype(np.float64)
        self.Nc = {}
        for name, n, _cb in self.coeff_meta:
            tab = Nc.get(name)
            if n == 1:
                self.Nc[name] = None
                continue
            tab = np.asarray(tab, np.float64)
            if tab.shape != (self.nq, n):
                raise ValueError(f"Nc[{name!r}] of shape {tab.shape}, "
                                 f"expected ({self.nq}, {n})")
            self.Nc[name] = tab.astype(work).astype(np.float64)
        nq = self.nq
        self.dg = nq * nv * gd + nq + (nq * gd if self.x_rows else 0)

    # -- the plain version --------------------------------------------------

    def ops_per_cell(self, n_states: int) -> int:
        """Floating-point operations of one cell's element vector: at every
        point the graph's arithmetic nodes, the reduced variables of each
        state, the coefficient components and the chain back, plus the sum
        over the points."""
        gm = self.grad_gm if n_states == 1 else self.jvp_gm
        free = {aten.full_like.default, aten._to_copy.default,
                aten.where.self, *_COMPARE}
        graph = sum(1 for n in gm.graph.nodes
                    if n.op == "call_function" and n.target not in free)

        def lin_ops(w):  # products (non-unit weights) and adds of one sum
            nz = w[w != 0.0]
            return int((nz != 1.0).sum()) + max(len(nz) - 1, 0)

        bs, gd, nv = self.bs, self.gd, self.nv
        total = 0
        for q in range(self.nq):
            red = bs * gd * (2 * nv - 1) + bs * lin_ops(self.Nf[q])
            coef = sum(cb * lin_ops(self.Nc[name][q]) for name, n, cb
                       in self.coeff_meta if n > 1)
            chain = nv * bs * (2 * gd - 1) + bs * sum(
                1 + int(w != 1.0) for w in self.Nf[q] if w != 0.0)
            total += graph + n_states * red + coef + chain
        return total + (self.nq - 1) * nv * bs

    @staticmethod
    def _lin(get, weights: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        """sum_k weights[q, k] * get(k) at every point q at once, (nq,
        *like.shape): zero weights skipped, unit weights not multiplied,
        the first term starting the sum, zero where no weight is nonzero --
        per point, what the kernel's loop computes (a product with 1 is
        exact, and a skipped term is left out by selection)."""
        nq = weights.shape[0]
        view = (nq,) + (1,) * like.dim()
        acc = None
        have = np.zeros(nq, bool)
        for k in range(weights.shape[1]):
            wk = weights[:, k]
            nz = wk != 0.0
            if not nz.any():
                continue
            x = get(k).unsqueeze(0)
            t = x.expand(view[:1] + x.shape[1:]) if (wk[nz] == 1.0).all() \
                else x * torch.as_tensor(wk, dtype=x.dtype,
                                         device=x.device).view(view)
            if not have.any():
                s = t
            elif have.all():
                s = acc + t
            else:
                s = torch.where(torch.as_tensor(have, device=x.device).view(
                    view), acc + t, t)
            if acc is None:
                acc = torch.zeros(view[:1] + like.shape, dtype=like.dtype,
                                  device=like.device)
            acc = s if nz.all() else torch.where(
                torch.as_tensor(nz, device=x.device).view(view), s, acc)
            have |= nz
        if acc is None:
            acc = torch.zeros(view[:1] + like.shape, dtype=like.dtype,
                              device=like.device)
        return acc

    def reduced(self, u, dN):
        """The reduced variables of the dof rows ``u`` (row v*bs+c) at
        every point at once, each (nq, ...): ``dN[v][d]`` the (nq, ...)
        rows of dN[q][v][d]."""
        bs, gd, nv = self.bs, self.gd, self.nv
        a = []
        for c in range(bs):
            for d in range(gd):
                acc = u[c] * dN[0][d]
                for v in range(1, nv):
                    acc = acc + u[v * bs + c] * dN[v][d]
                a.append(acc)
        for c in range(bs):
            a.append(self._lin(lambda v: u[v * bs + c], self.Nf, u[0]))
        return a

    def coeff_inputs(self, cd):
        """The coefficient components at every point, each (nq, ...), from
        the rows ``cd``."""
        comps, off = [], 0
        nq = self.nq
        for name, n, cb in self.coeff_meta:
            for j in range(cb):
                if n == 1:
                    c1 = cd[off + j]
                    comps.append(c1.unsqueeze(0).expand((nq,) + c1.shape))
                else:
                    comps.append(self._lin(
                        lambda i: cd[off + i * cb + j], self.Nc[name],
                        cd[0]))
            off += n * cb
        return comps

    def elem_vectors(self, u_blocks, cds):
        """The element gradient (one state) or Hessian-vector product
        (two) on tensors: ``u_blocks`` one or two (nv*bs, ...) dof blocks,
        ``cds`` = (geometry rows (dg, ...), [coefficient rows (Dc, ...)]).
        The points are stacked on a leading axis, so that each operation of
        the kernel's per-point loop runs once for all of them (elementwise:
        every point's values are the kernel's), and the element vector is
        their sum in point order. Returns (nv*bs, ...) -- what the kernel
        computes, in its order."""
        bs, gd, nv, nG, nq = self.bs, self.gd, self.nv, self.nG, self.nq
        geom = cds[0]
        w0, x0 = nq * nv * gd, nq * nv * gd + nq
        dNq = geom[:w0].unflatten(0, (nq, nv, gd))
        dN = [[dNq[:, v, d] for d in range(gd)] for v in range(nv)]
        w = geom[w0:w0 + nq]
        if self.x_rows:
            xq = geom[x0:x0 + nq * gd].unflatten(0, (nq, gd))
            x = [xq[:, d] for d in range(gd)]
        else:
            x = [torch.zeros_like(w)] * gd
        cin = self.coeff_inputs(cds[1]) if self.n_comp else []
        ins = [*self.reduced(u_blocks[0], dN), w, *x, *cin]
        if len(u_blocks) == 1:
            g = self.grad_gm(*ins)
        else:
            g = self.jvp_gm(*ins, *self.reduced(u_blocks[1], dN))
        shape = w.shape
        rows = []
        for v in range(nv):
            wv = self.Nf[:, v]
            nz = wv != 0.0
            for c in range(bs):
                e = g[c * gd] * dN[v][0]
                for d in range(1, gd):
                    e = e + g[c * gd + d] * dN[v][d]
                e = e.expand(shape)
                if nz.any():
                    gv = g[nG + c].expand(shape)
                    t = gv if (wv[nz] == 1.0).all() else gv * torch.as_tensor(
                        wv, dtype=gv.dtype, device=gv.device).view(
                        (nq,) + (1,) * (gv.dim() - 1))
                    e = e + t if nz.all() else torch.where(
                        torch.as_tensor(nz, device=gv.device).view(
                            (nq,) + (1,) * (gv.dim() - 1)), e + t, e)
                acc = e[0]
                for q in range(1, nq):
                    acc = acc + e[q]
                rows.append(acc)
        return torch.stack(rows)

    # -- the C form ----------------------------------------------------------

    def c_struct(self, target: str = "cuda", name: str = "GenPhys") -> str:
        """The physics as C++ for ``csrc/lane_fused_gen_mq.cuh``: the basis
        value tables (``GEN_TABLE`` arrays: constant memory on the card)
        and a struct of its sizes and four functions, ``nf(q, v)``,
        ``coeffs`` (point q, staged coefficient rows with row stride
        ``rs`` -> components at q), ``grad`` and ``jvp`` (the point
        graphs, as in :meth:`GenPhysics.c_struct`)."""
        dt = self.dtype
        ctype = "float" if dt == torch.float32 else "double"
        nR, gd = self.nR, self.gd

        def table(tname, tab):
            vals = ", ".join(_lit(float(x), dt) for x in tab.reshape(-1))
            return f"GEN_TABLE {ctype} {tname}[{tab.size}] = {{{vals}}};"

        tables = [table(f"{name}_nf", self.Nf)]
        cl, off, k = [], 0, 0
        for ci, (cname, n, cb) in enumerate(self.coeff_meta):
            if n > 1:
                tables.append(table(f"{name}_nc{ci}", self.Nc[cname]))
            for j in range(cb):
                if n == 1:
                    cl.append(f"cin[{k}] = rows[{off + j}LL * rs];")
                else:
                    cl += [
                        "{",
                        "  GT acc = (GT)0;",
                        "  bool have = false;",
                        "#pragma unroll",
                        f"  for (int i = 0; i < {n}; ++i) {{",
                        f"    const GT w = {name}_nc{ci}[q * {n} + i];",
                        "    if (w == (GT)0) continue;",
                        f"    const GT r = rows[({off + j} + i * {cb}) * "
                        "(long long)rs];",
                        "    const GT t = w == (GT)1 ? r : r * w;",
                        "    acc = have ? acc + t : t;",
                        "    have = true;",
                        "  }",
                        f"  cin[{k}] = acc;",
                        "}",
                    ]
                k += 1
            off += n * cb
        ins = [f"in[{i}]" for i in range(self.n_in)]
        body = {
            "grad": emit(self.grad_gm, ins, "out", dt, target),
            "jvp": emit(self.jvp_gm, ins + [f"din[{i}]" for i in range(nR)],
                        "out", dt, target),
        }

        def block(lines):
            return "\n".join("    " + s for s in lines)

        nl = "\n"
        return f"""{nl.join(tables)}
struct {name} {{
  typedef {ctype} GT;
  static constexpr int NV = {self.nv}, C = {self.bs}, GD = {gd};
  static constexpr int NQ = {self.nq}, XR = {int(self.x_rows)};
  static constexpr int DG = {self.dg}, DC = {self.n_coeff_rows};
  static constexpr int NCOMP = {self.n_comp}, NR = {nR}, NIN = {self.n_in};
  GEN_HD static GT nf(int q, int v) {{ return {name}_nf[q * NV + v]; }}
  GEN_HD static void coeffs(int q, const GT* __restrict__ rows, long long rs,
                            GT* __restrict__ cin) {{
    (void)q; (void)rows; (void)rs; (void)cin;
{block(cl)}
  }}
  GEN_HD static void grad(const GT* __restrict__ in, GT* __restrict__ out) {{
{block(body['grad'])}
  }}
  GEN_HD static void jvp(const GT* __restrict__ in,
                         const GT* __restrict__ din, GT* __restrict__ out) {{
    (void)din;
{block(body['jvp'])}
  }}
}};
"""

    def cuda_source(self, itype: torch.dtype,
                    layouts: Tuple[Tuple[int, int, bool], ...]) -> str:
        """The CUDA unit of the physics for index type ``itype``: the
        launchers ``lane_fused_gen_launch1`` (gradient) and ``..._launch2``
        (Hessian-vector product) of csrc/lane_fused_gen_mq.cuh, each with
        its block layout ``(lb, ky, window staged)`` of ``layouts``."""
        if self._c_cuda is None:
            self._c_cuda = self.c_struct("cuda")
        ity = {torch.int8: "int8_t", torch.int32: "int32_t"}[itype]
        entries = "\n".join(
            f"LANE_FUSED_GEN_MQ_ENTRY(GenPhys, {ity}, {ns}, {lb}, {ky}, "
            f"{str(bool(win)).lower()})"
            for ns, (lb, ky, win) in enumerate(layouts, start=1))
        return f"""// generated: the element physics of one multi-quadrature-point
// integrand, traced (tpufem_torch/lane/fused_gen.py), in the fused
// kernel's multi-point template
#include "lane_fused_gen_mq.cuh"
{self._c_cuda}
{entries}
"""
