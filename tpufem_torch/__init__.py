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
- :mod:`tpufem_torch.assemble`  -- flat (cell-major) assembler: the f64 oracle,
  the load-vector / postprocess path and the Dirichlet-lifted Newton system.
- :mod:`tpufem_torch.la`, :mod:`tpufem_torch.nls` -- CG with the reference's
  stopping rule, Jacobi, Newton with both convergence conventions.
- :mod:`tpufem_torch.lane`      -- lane-partitioned unstructured engine and its
  CUDA kernels; Newton-Krylov solver on the lane layout.
- :mod:`tpufem_torch.io`        -- VTU / XDMF / HDF5 output, checkpoints.
- :mod:`tpufem_torch.cases`     -- complete workloads (mechanic2d, polycrystal)
  and the IN_COMP comparison harness.
"""

__version__ = "0.1.0"

from tpufem_torch import config as config

__all__ = ["config", "__version__"]
