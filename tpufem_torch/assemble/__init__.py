"""Assembly: batched element kernels -> global residual.

The flat (cell-major) path: the per-cell kernel runs vmapped over all
cells at once; insertion is a deterministic padded gather-sum. It is the
float64 oracle of the lane engine and the load-vector / postprocess path
of the workloads. The assembled sparse matrix is not ported yet.
"""

from tpufem_torch.assemble.assembler import Assembler
from tpufem_torch.assemble.scatter import GatherSumPlan

__all__ = ["Assembler", "GatherSumPlan"]
