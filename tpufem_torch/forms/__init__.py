"""Physics as energy densities; AD-derived residuals and tangents.

Write psi(eps, coeffs) with tensor arithmetic, get sigma = d psi/d eps via
``torch.func.grad`` and the consistent tangent via ``torch.func.hessian``
(or ``jvp`` of the gradient for the matrix-free action).
"""

from tpufem_torch.forms.potentials import (
    linear_elastic_psi,
    asym_damage_psi,
    asym_damage_stress_manual,
    asym_damage_stress_jvp_manual,
    lame_parameters,
    neo_hookean_psi,
)
from tpufem_torch.forms.form import EnergyFunctional, Coefficient

__all__ = [
    "linear_elastic_psi",
    "asym_damage_psi",
    "asym_damage_stress_manual",
    "asym_damage_stress_jvp_manual",
    "lame_parameters",
    "neo_hookean_psi",
    "EnergyFunctional",
    "Coefficient",
]
