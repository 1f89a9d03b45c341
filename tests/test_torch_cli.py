"""The port's command line against tpufem's: the ``mechanic2d`` subcommand
with the reference's flags and defaults and output lines, exit code 2 when
Newton does not converge, ``polycrystal --output``, and the parser
defaults of ``polycrystal``, ``elasticity3d`` and ``neohookean`` with runs
of the last two."""

import numpy as np
import pytest
import torch

import tpufem.cli as j_cli
import tpufem_torch.cli as t_cli
from tpufem_torch.io import read_xdmf
from test_torch_memory import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)


def test_mechanic2d_parser_defaults_equal_the_reference_s():
    t = vars(t_cli.build_parser().parse_args(["mechanic2d"]))
    j = vars(j_cli.build_parser().parse_args(["mechanic2d"]))
    t.pop("fn"), j.pop("fn")
    assert t.pop("device") == "cuda"
    assert t == j
    argv = ["mechanic2d", "-r", "2", "--rel", "1e-6", "--abs", "1e-9",
            "--maxit", "4", "--cg-rtol", "1e-9", "--cg-maxit", "50",
            "--convergence", "du0", "--pc", "amg", "--compression",
            "--ecst", "--max-dam", "0.5", "--degree", "2", "--mesh", "m.msh",
            "--output", "out"]
    t = vars(t_cli.build_parser().parse_args(argv))
    j = vars(j_cli.build_parser().parse_args(argv))
    t.pop("fn"), j.pop("fn"), t.pop("device")
    assert t == j


def test_mechanic2d_prints_the_reference_s_lines(capsys):
    assert t_cli.main(["--device", "cpu", "--x64", "mechanic2d"]) == 0
    t_out = capsys.readouterr().out.splitlines()
    assert j_cli.main(["--x64", "mechanic2d"]) == 0
    j_out = capsys.readouterr().out.splitlines()
    assert t_out[:3] == j_out[:3]
    assert t_out[0] == "newton iterations: 5  cg: [63, 62, 63, 63, 64]"
    # the phase table: the reference's rows in the reference's order
    assert [ln.split("|")[-2].strip() for ln in t_out[2:]] == [
        ln.split("|")[-2].strip() for ln in j_out[2:]]


def test_mechanic2d_nonconvergence_returns_2(capsys):
    rc = t_cli.main(["--device", "cpu", "--x64", "mechanic2d", "--maxit",
                     "1"])
    assert rc == 2
    assert "NONCONVERGED" in capsys.readouterr().err


def test_mechanic2d_unported_preconditioner_raises():
    """mechanic2d runs Jacobi only (the reference's run uses Jacobi
    whatever --pc says): amg and block_jacobi raise ValueError; polycrystal
    takes --pc amg for the mixed solve only."""
    for pc in ("amg", "block_jacobi"):
        with pytest.raises(ValueError, match="mechanic2d.py:249"):
            t_cli.main(["--device", "cpu", "mechanic2d", "--pc", pc])
    ap = t_cli.build_parser()
    assert ap.parse_args(["polycrystal", "--mixed", "--pc", "amg"]).pc == (
        "amg")
    with pytest.raises(ValueError, match="without a word"):
        t_cli.main(["--device", "cpu", "--x64", "polycrystal", "-n", "4",
                    "--grains", "2", "--smooth-iters", "1", "--pc", "amg"])


def test_polycrystal_output_reads_back(tmp_path, capsys):
    out = tmp_path / "poly.xdmf"
    rc = t_cli.main(["--device", "cpu", "--x64", "polycrystal", "-n", "8",
                     "--grains", "4", "--smooth-iters", "2", "--pc",
                     "jacobi", "--cg-rtol", "1e-8", "--rel", "1e-6",
                     "--output", str(out)])
    assert rc == 0 and "8 outputs" in capsys.readouterr().out
    mesh, pd, cd = read_xdmf(str(out))
    assert (tmp_path / "poly.h5").exists()
    assert sorted(pd) == ["damage", "u"]
    assert sorted(cd) == ["E", "energy_density", "grain", "strain", "stress"]
    assert pd["u"].shape == (mesh.n_nodes, 3)
    assert np.isfinite(pd["u"]).all() and np.abs(pd["u"][:, :2]).max() > 0
    np.testing.assert_array_equal(pd["u"][:, 2], 0.0)


# the keys whose defaults differ from the reference's on purpose: the
# port's --device; polycrystal's --fused (the port's staged / fused
# switch) and --pc (the port names its default, twolevel; the reference
# leaves None and picks twolevel later)
DIFFERENT_ON_PURPOSE = {"polycrystal": ("device", "fused", "pc"),
                        "elasticity3d": ("device",),
                        "neohookean": ("device",)}


@pytest.mark.parametrize("cmd", sorted(DIFFERENT_ON_PURPOSE))
def test_parser_defaults_equal_the_reference_s(cmd):
    t = vars(t_cli.build_parser().parse_args([cmd]))
    j = vars(j_cli.build_parser().parse_args([cmd]))
    t.pop("fn"), j.pop("fn")
    for k in DIFFERENT_ON_PURPOSE[cmd]:
        t.pop(k), j.pop(k, None)
    assert t == j
    argv = [cmd, "--rel", "1e-6", "--convergence", "du0", "--cg-rtol",
            "1e-9", "--maxit", "3"]
    t = vars(t_cli.build_parser().parse_args(argv))
    j = vars(j_cli.build_parser().parse_args(argv))
    for k in ("rel", "convergence", "cg_rtol", "maxit"):
        assert t[k] == j[k], k


@pytest.mark.parametrize("argv", [
    ["elasticity3d", "-n", "2"],
    ["elasticity3d", "-n", "2", "--matrix", "--cell", "tetra"],
    ["neohookean", "-n", "2"],
])
def test_flat_subcommands_print_the_reference_s_line(argv, capsys):
    """The reference's result line ``dofs: N  newton=K |r|=R``, then the
    CG count and the stage seconds; exit 0 when converged and 2 when not
    (``--maxit 0``: no Newton step)."""
    assert t_cli.main(["--device", "cpu", "--x64", *argv]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("dofs: 81  newton=") and "|r|=" in out[0]
    assert out[1].startswith("cg: ") and "converged: True" in out[1]
    assert t_cli.main(["--device", "cpu", "--x64", *argv, "--maxit",
                       "0"]) == 2
