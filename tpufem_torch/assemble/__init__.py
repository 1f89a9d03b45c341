"""Assembly: batched element kernels -> global residual.

The flat (cell-major) path: the per-cell kernel runs vmapped over all
cells at once; insertion is a deterministic padded gather-sum (also into
the nnz slots of the assembled ELL matrix). It is the float64 oracle of the lane engine, the load-vector / postprocess path
of the workloads and the operator of the flat Newton solvers.
"""

from tpufem_torch.assemble.assembler import Assembler
from tpufem_torch.assemble.pattern import EllMatrix, SparsityPattern
from tpufem_torch.assemble.scatter import GatherSumPlan

__all__ = ["Assembler", "GatherSumPlan", "EllMatrix", "SparsityPattern"]
