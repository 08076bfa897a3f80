"""Port parity: the quenched path end to end through run_LQCD (the JAX
package) and run_lqcd_file / python -m latticeqcd_torch.run (the port). A
Heatbath TOML with flowed measurements writes the JAX package's files and
line formats, a Fileloading run with flowed measurements gives its
numbers, a heatbath run resumes bit for bit, and what is not ported is
refused."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import latticeqcd_tpu  # noqa: E402
from latticeqcd_tpu.io import save_u as jsave_u  # noqa: E402
from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_torch.system.lqcd import run_lqcd_file, run_lqcd_params  # noqa: E402
from latticeqcd_torch.system.params import Params  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAT = (4, 4, 4, 4)

GAUGE_METHODS = """  {methodname = "Plaquette", measure_every = 1},
  {methodname = "Polyakov_loop", measure_every = 1},
  {methodname = "Topological_charge", measure_every = 1},
  {methodname = "Energy_density", measure_every = 1},
  {methodname = "Wilson_loop", measure_every = 2},
"""

# the Heatbath TOML of tests/test_driver.py with flowed Energy_density, plus the gauge observables
HEATBATH_TOML = """
[System_Settings]
L = [4, 4, 4, 4]
NC = 3
Nthermalization = 0
Nsteps = 2
update_method = "Heatbath"
quench = true
useOR = true
numOR = 2
verboselevel = 1
beta = 5.7
initial = "cold"
randomseed = 111

[Measurement_set]
measurement_basedir = "./measurements"
measurement_dir = "spec"
measurement_methods = [
  {methodname = "Plaquette", measure_every = 1},
  {methodname = "Dirac_spectrum", measure_every = 1, Neig = 3, Nlanczos = 48, fermion_parameters = {Dirac_operator = "Staggered", mass = 0.5}},
  {methodname = "Topological_charge", measure_every = 1},
  {methodname = "Wilson_loop", measure_every = 2, Rmax = 2, Tmax = 3},
]

[gradientflow_measurements]
numflow = 3
Nflow = 1
eps_flow = 0.02
measurements_for_flow = [
  {methodname = "Energy_density", measure_every = 1},
  {methodname = "Topological_charge", measure_every = 2, kinds_of_topological_charge = ["clover"]},
]
"""


def _files(d):
    return sorted(os.listdir(d))


def _shape(line):
    """A line with every number replaced by its kind: the format without the values."""
    out = []
    for tok in line.split():
        try:
            float(tok)
            out.append("int" if tok.lstrip("-").isdigit() else "num")
        except ValueError:
            out.append(tok)
    return out


def _numbers(line):
    vals = []
    for tok in line.split():
        try:
            vals.append(float(tok))
        except ValueError:
            pass
    return vals


def test_heatbath_toml_writes_the_jax_packages_files(tmp_path, monkeypatch):
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "spec.toml").write_text(HEATBATH_TOML)
    monkeypatch.chdir(tmp_path / "jax")
    assert np.isfinite(latticeqcd_tpu.run_LQCD("spec.toml"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "latticeqcd_torch.run", "spec.toml", "--device",
                          "cpu"], cwd=tmp_path / "torch", env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    plaq = float(out.stdout.split("final plaquette = ")[1].split()[0])
    assert 0.3 < plaq < 1.0
    jdir, tdir = tmp_path / "jax" / "measurements" / "spec", tmp_path / "torch" / "measurements" / "spec"
    names = _files(jdir)
    assert names == _files(tdir) == [
        "Dirac_spectrum.txt", "Energy_density_flow.txt", "Plaquette.txt",
        "Topological_charge.txt", "Topological_charge_flow.txt", "Wilson_loop.txt"]
    for name in names:
        jl = (jdir / name).read_text().splitlines()
        tl = (tdir / name).read_text().splitlines()
        assert len(jl) == len(tl) > 0, name
        for a, b in zip(jl, tl):
            assert _shape(a) == _shape(b), (name, a, b)
            # itrj, and for a flowed line itrj istep tau, are the same
            n = 4 if name.endswith("_flow.txt") else 1
            assert _numbers(a)[:n] == _numbers(b)[:n], (name, a, b)
    flow = (tdir / "Energy_density_flow.txt").read_text().splitlines()
    assert [line.split()[:4] for line in flow[:3]] == [["1", "1", "1", "0.02"],
                                                       ["1", "1", "2", "0.04"],
                                                       ["1", "1", "3", "0.06"]]
    assert (tdir / "Topological_charge.txt").read_text().splitlines()[0].endswith(
        "# itrj Qplaq Qclover Qimproved")


def _save_configurations(d, n=3):
    d.mkdir()
    for i in range(n):
        jsave_u(str(d / f"conf_{i + 1:08d}.npz"), jfields.hot_start(LAT, 3, seed=60 + i))


def _fileloading_toml(confdir, measuredir):
    return f"""
[System_Settings]
L = [4, 4, 4, 4]
NC = 3
update_method = "Fileloading"
loadU_format = "NPZ"
loadU_dir = "{confdir}"
quench = true
verboselevel = 1
beta = 6.0
initial = "cold"

[Measurement_set]
measurement_basedir = "{measuredir}"
measurement_dir = "m"
measurement_methods = [
{GAUGE_METHODS}]

[gradientflow_measurements]
numflow = 4
Nflow = 2
eps_flow = 0.02
measurements_for_flow = [
  {{methodname = "Energy_density", measure_every = 1}},
  {{methodname = "Topological_charge", measure_every = 2, kinds_of_topological_charge = ["plaquette", "clover"]}},
  {{methodname = "Plaquette", measure_every = 4}},
]
"""


def test_fileloading_flowed_series_match_the_jax_package(tmp_path, monkeypatch):
    confdir = tmp_path / "confs"
    _save_configurations(confdir)
    monkeypatch.chdir(tmp_path)
    for side in ("jax", "torch"):
        (tmp_path / f"{side}.toml").write_text(_fileloading_toml(confdir, tmp_path / side))
    latticeqcd_tpu.run_LQCD("jax.toml")
    run_lqcd_file("torch.toml", dtype=torch.complex128, device="cpu")
    jdir, tdir = tmp_path / "jax" / "m", tmp_path / "torch" / "m"
    names = _files(jdir)
    assert names == _files(tdir) and len(names) == 8
    for name in names:
        jl = (jdir / name).read_text().splitlines()
        tl = (tdir / name).read_text().splitlines()
        assert len(jl) == len(tl) > 0, name
        for a, b in zip(jl, tl):
            assert _shape(a) == _shape(b), (name, a, b)
            np.testing.assert_allclose(_numbers(b), _numbers(a), rtol=0, atol=1e-10)
    # 3 configurations x 4 flow steps (the starting links are not flowed)
    assert len((tdir / "Energy_density_flow.txt").read_text().splitlines()) == 3 * 4


def _heatbath_params(tmp_path, **kw):
    base = dict(L=LAT, NC=3, beta=5.7, initial="hot", update_method="Heatbath", quench=True,
                useOR=True, numOR=1, Nsteps=4, randomseed=9, verboselevel=1,
                measuredir=str(tmp_path / "m"), saveU_format="NPZ", saveU_dir=str(tmp_path / "s"),
                saveU_every=1, numflow=2, eps_flow=0.02, hasgradientflow=True,
                measurement_methods=[{"methodname": "Plaquette"},
                                     {"methodname": "Topological_charge"}],
                measurements_for_flow=[{"methodname": "Energy_density"}])
    base.update(kw)
    return Params(**base)


def test_heatbath_resume_is_bitwise(tmp_path):
    """2 steps and a resume of 2 more equal 4 straight, the links and every
    measurement series, flowed ones included."""
    (tmp_path / "a" / "s").mkdir(parents=True)
    (tmp_path / "b" / "s").mkdir(parents=True)
    history = []
    run_lqcd_params(_heatbath_params(tmp_path / "a"), dtype=torch.complex128, device="cpu",
                    history=history)
    assert [r["itrj"] for r in history] == [1, 2, 3, 4]
    assert all(r["dH"] is None and r["plaq"] is None and r["accepted"] for r in history)
    assert all(r["flow_seconds"] is not None for r in history)
    run_lqcd_params(_heatbath_params(tmp_path / "b", Nsteps=2), dtype=torch.complex128,
                    device="cpu")
    run_lqcd_params(_heatbath_params(tmp_path / "b"), dtype=torch.complex128, device="cpu",
                    resume_checkpoint=str(tmp_path / "b" / "s" / "checkpoint.npz"))
    for name in ("conf_00000004.npz", "checkpoint.npz"):
        with np.load(tmp_path / "a" / "s" / name) as za, np.load(tmp_path / "b" / "s" / name) as zb:
            assert np.array_equal(za["u"], zb["u"])
    for name in ("Plaquette.txt", "Topological_charge.txt", "Energy_density_flow.txt"):
        a = (tmp_path / "a" / "m" / name).read_text()
        assert a == (tmp_path / "b" / "m" / name).read_text(), name
        assert len(a.splitlines()) == (5 if "flow" not in name else 8)


def test_heatbath_with_fermions_raises(tmp_path):
    p = _heatbath_params(tmp_path, quench=False, Dirac_operator="Wilson", saveU_format=None,
                         measuredir="")
    with pytest.raises(ValueError, match="only for quench"):
        run_lqcd_params(p, device="cpu")


@pytest.mark.parametrize("field,value,item", [
    ("smearing_for_fermion", "stout", "A12"), ("couplinglist", ["rectangular"], "A3"),
    ("update_method", "SLMC", "A12"),
])
def test_quenched_path_still_refuses_what_is_not_ported(tmp_path, field, value, item):
    p = _heatbath_params(tmp_path, saveU_format=None, measuredir="", **{field: value})
    if field == "smearing_for_fermion":
        # ported: built and unused by a quenched heatbath, as in the JAX package
        from latticeqcd_torch.system.universe import build_universe

        assert build_universe(p, device="cpu").cov_neural_net is not None
        p, q = (_heatbath_params(tmp_path, saveU_format=None, measuredir="", Nsteps=1, **kw)
                for kw in ({field: value}, {}))
        assert run_lqcd_params(p, device="cpu") == run_lqcd_params(q, device="cpu")
        return
    if field == "couplinglist":
        # ported: a quenched heatbath of the Symanzik-type plaquette + rectangle action runs
        history = []
        p = _heatbath_params(tmp_path, saveU_format=None, measuredir="", Nsteps=1,
                             couplingcoeff=[-5.7 / 20], numflow=0, **{field: value})
        plaq = run_lqcd_params(p, device="cpu", history=history)
        assert 0.0 < plaq < 1.0 and len(history) == 1
        return
    # ported: SLMC proposes coupling-basis heatbath sweeps and learns beta_eff
    history = []
    p = _heatbath_params(tmp_path, saveU_format=None, measuredir="", Nsteps=2, numflow=0,
                         beta_eff=5.0, firstlearn=1, **{field: value})
    plaq = run_lqcd_params(p, device="cpu", history=history)
    assert 0.0 < plaq < 1.0 and len(history) == 2
    assert abs(history[-1]["beta_eff"][0] - p.beta) < 1e-6  # the first fit is exact


def test_one_instanton_start_runs_the_heatbath(tmp_path):
    history = []
    p = _heatbath_params(tmp_path, NC=2, beta=2.3, L=(4, 4, 4, 6), initial="one instanton",
                         Nsteps=1, saveU_format=None, measuredir="")
    plaq = run_lqcd_params(p, device="cpu", history=history)
    assert 0.3 < plaq < 1.0 and len(history) == 1
