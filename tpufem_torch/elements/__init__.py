"""Reference elements: tabulated bases, quadrature, geometry maps."""

from tpufem_torch.elements.quadrature import quadrature
from tpufem_torch.elements.lagrange import Element, element

__all__ = ["quadrature", "Element", "element"]
