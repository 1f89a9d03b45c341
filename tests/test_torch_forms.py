"""tpufem_torch constitutive laws against tpufem's (float64, same numpy
strains through both): value, gradient and Hessian of the asymmetric
elasto-damage energy, including the points where the spectral form is
singular (zero strain, spherical strain). Tolerance rel <= 1e-14: same
formula, same order of operations; AD may reassociate a few terms.
Also: importing the port pulls in neither jax nor tpufem."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, hessian, jvp

import tpufem.forms as j_forms
import tpufem_torch.forms as t_forms
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

E, NU = 1.0e6, 0.3


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


_STRAINS = {
    "zero": np.zeros((2, 2)),
    "spherical_tension": 1e-3 * np.eye(2),
    "spherical_compression": -2e-3 * np.eye(2),
    "tension": np.array([[2e-3, 3e-4], [3e-4, 5e-4]]),
    "compression": np.array([[-2e-3, 1e-4], [1e-4, -7e-4]]),
    "mixed": np.array([[1e-3, 4e-4], [4e-4, -8e-4]]),
    "shear": np.array([[0.0, 1e-3], [1e-3, 0.0]]),
}


@pytest.mark.parametrize("case", sorted(_STRAINS))
def test_asym_damage_psi_value_grad_hessian(case):
    eps = _STRAINS[case]
    d, Ey = 0.6, 3.0e7
    fj = lambda e: j_forms.asym_damage_psi(e, d, Ey, NU)
    ft = lambda e: t_forms.asym_damage_psi(e, d, Ey, NU)
    ej, et = jnp.asarray(eps), torch.from_numpy(eps.copy())
    vj, gj, hj = fj(ej), jax.grad(fj)(ej), jax.hessian(fj)(ej)
    vt, gt, ht = ft(et), grad(ft)(et), hessian(ft)(et)
    for t in (vt, gt, ht):
        assert torch.isfinite(t).all()  # the where/sqrt NaN trap
    scale = max(float(np.abs(np.asarray(hj)).max()), 1.0)
    assert abs(float(vt) - float(vj)) <= 1e-14 * max(abs(float(vj)), 1e-300)
    assert _rel(gt.numpy(), gj) <= 1e-14 or np.abs(np.asarray(gj)).max() == 0
    assert np.abs(ht.numpy() - np.asarray(hj)).max() <= 1e-14 * scale
    # hand-derived stress agrees with AD (variant-redundancy gate)
    sm = t_forms.asym_damage_stress_manual(et, d, Ey, NU).numpy()
    gsym = 0.5 * (gt.numpy() + gt.numpy().T)
    assert np.abs(sm - gsym).max() <= 1e-14 * max(np.abs(gsym).max(), 1.0)


@pytest.mark.parametrize("d", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("case", sorted(_STRAINS))
def test_asym_damage_manual_stress_and_jvp_match_ad(case, d):
    """The hand-derived stress and its directional derivative (what the
    fused kernel computes) against ``grad`` / ``jvp(grad)`` of the energy:
    zero strain, spherical strain (delta == 0), negative eigenvalues,
    sound, damaged and fully damaged material. Tolerance 1e-13 of the
    largest entry: same formulas up to the order of a few operations."""
    Ey = 3.0e7
    eps = torch.from_numpy(_STRAINS[case].copy())
    f = lambda e: t_forms.asym_damage_psi(e, d, Ey, NU)
    rng = np.random.default_rng(4)
    g = grad(f)(eps)
    sm = t_forms.asym_damage_stress_manual(eps, d, Ey, NU)
    assert torch.isfinite(sm).all()
    assert (sm - 0.5 * (g + g.T)).abs().max() <= 1e-13 * max(
        float(g.abs().max()), 1.0)
    for _ in range(3):
        t = rng.standard_normal((2, 2))
        t = torch.from_numpy(t + t.T)
        jg = jvp(grad(f), (eps,), (t,))[1]
        jm = t_forms.asym_damage_stress_jvp_manual(eps, t, d, Ey, NU)
        assert torch.isfinite(jm).all()
        assert (jm - 0.5 * (jg + jg.T)).abs().max() <= 1e-13 * float(
            jg.abs().max())


def test_tagged_energies_record_their_calls():
    """The fused engine learns an integrand's law from the tags."""
    from tpufem_torch.forms.potentials import record_fused_laws

    eps = torch.from_numpy(_STRAINS["mixed"].copy())
    d = torch.tensor(0.5, dtype=torch.float64)
    t_forms.asym_damage_psi(eps, d, E, NU)  # outside a recording: no trace
    with record_fused_laws() as calls:
        t_forms.asym_damage_psi(eps, d, E, NU)
        t_forms.linear_elastic_psi(eps, E, NU)
    assert [c[0] for c in calls] == ["asym_damage", "linear_elastic"]
    assert calls[0][1][1] is d and calls[1][1][1:] == (E, NU)
    with record_fused_laws() as again:
        pass
    assert again == [] and len(calls) == 2


def test_linear_elastic_psi_matches():
    eps = _STRAINS["mixed"]
    vj = j_forms.linear_elastic_psi(jnp.asarray(eps), E, NU)
    vt = t_forms.linear_elastic_psi(torch.from_numpy(eps.copy()), E, NU)
    assert abs(float(vt) - float(vj)) <= 1e-14 * abs(float(vj))


def test_import_pulls_in_neither_jax_nor_tpufem():
    code = (
        "import sys\n"
        "import tpufem_torch, tpufem_torch.cli, tpufem_torch.cases.polycrystal\n"
        "import tpufem_torch.lane, tpufem_torch.assemble, tpufem_torch.utils.convert\n"
        "import tpufem_torch.perf.cg_profile, tpufem_torch.lane._build\n"
        "import tpufem_torch.cases.mechanic2d, tpufem_torch.cases.compare\n"
        "import tpufem_torch.io, tpufem_torch.nls, tpufem_torch.la\n"
        "import tpufem_torch.mesh, tpufem_torch.perf, tpufem_torch.utils.log\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tpufem' or m.startswith('tpufem.')]\n"
        "assert not bad, bad\n"
    )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
