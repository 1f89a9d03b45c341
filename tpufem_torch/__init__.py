"""tpufem_torch -- the PyTorch/CUDA port of the tpufem finite element framework.

Same sub-packages and function names as ``tpufem``, so a reader finds the
counterpart; tensors are ``torch`` tensors, irregular lane access runs in
hand-written CUDA kernels (``csrc/``), and every entry point takes an explicit
``device=`` (default CUDA) and ``dtype=`` (default ``torch.float32``).

Layering (bottom-up):

- :mod:`tpufem_torch.mesh`      -- host-side mesh generation and topology.
- :mod:`tpufem_torch.elements`  -- reference elements, quadrature, geometry.
- :mod:`tpufem_torch.spaces`    -- function spaces, dofmaps, Dirichlet BCs.
- :mod:`tpufem_torch.forms`     -- physics as energy densities;
  ``torch.func.grad``/``jvp``/``hessian`` derive residuals and tangents.
- :mod:`tpufem_torch.assemble`  -- flat (cell-major) assembler: the f64 oracle
  and the load-vector / postprocess path.
- :mod:`tpufem_torch.lane`      -- lane-partitioned unstructured engine and its
  CUDA kernels; Newton-Krylov solver on the lane layout.
- :mod:`tpufem_torch.cases`     -- complete workloads (polycrystal).
"""

__version__ = "0.1.0"

from tpufem_torch import config as config

__all__ = ["config", "__version__"]
