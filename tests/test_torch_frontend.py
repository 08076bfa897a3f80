"""Port parity: the front end. The legacy ``.jl`` input and the wizard (pinned
copies: byte-identical TOML and equal Params from both packages), the package
façade, the phase timers, ``--profile`` and the demo.

The repository holds no ``.jl`` file, so the legacy inputs below are written
into ``tmp_path``: a two-flavour Wilson HMC run, a staggered one, and a
quenched heatbath one with the measurement dicts of the reference's
test01.jl (an ``Array{Dict,1}(undef, 5)`` filled by indexed assignments).
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

import latticeqcd_tpu  # noqa: E402
import latticeqcd_torch  # noqa: E402
from latticeqcd_tpu.system import legacy_input as jli  # noqa: E402
from latticeqcd_tpu.system import params as jp  # noqa: E402
from latticeqcd_tpu.system import wizard as jwz  # noqa: E402
from latticeqcd_tpu.utils import timers as jtm  # noqa: E402
from latticeqcd_torch import demo  # noqa: E402
from latticeqcd_torch.system import legacy_input as tli  # noqa: E402
from latticeqcd_torch.system import lqcd as tlqcd  # noqa: E402
from latticeqcd_torch.system import params as tp  # noqa: E402
from latticeqcd_torch.system import wizard as twz  # noqa: E402
from latticeqcd_torch.utils import timers as ttm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WILSON_JL = """\
# legacy input: two-flavour Wilson HMC from a cold start
system["L"] = (4, 4, 4, 4)
system["β"] = 5.7
system["NC"] = 3
system["Nthermalization"] = 0
system["Nsteps"] = 2
system["initial"] = "cold"
system["initialtrj"] = 1
system["update_method"] = "HMC"
system["quench"] = false
system["Dirac_operator"] = "Wilson"
system["BoundaryCondition"] = [1, 1, 1, -1]
system["log_dir"] = "./logs"
system["logfile"] = "wilson.txt"
system["saveU_format"] = nothing
system["verboselevel"] = 2
system["randomseed"] = 111
#=
system["Nsteps"] = 1000
=#
wilson["hop"] = 0.141139 # kappa
wilson["r"] = 1
md["MDsteps"] = 5
md["Δτ"] = 0.5/md["MDsteps"]
md["SextonWeingargten"] = false
md["N_SextonWeingargten"] = 2
cg["eps"] = 1e-19
cg["MaxCGstep"] = 3000
measurement["measurement_basedir"] = "./measurements"
measurement["measurement_dir"] = "wilson"
measurement["measurement_methods"] = Dict[
  Dict{Any,Any}("methodname" => "Plaquette",
    "measure_every" => 1,
    "fermiontype" => nothing),
  Dict{Any,Any}("methodname" => "Polyakov_loop", "measure_every" => 1, "fermiontype" => nothing),
]
"""

STAGGERED_JL = """\
system["L"] = (4, 4, 4, 4)
system["β"] = 5.7
system["NC"] = 3
system["Nsteps"] = 10
system["initial"] = "hot"
system["update_method"] = "HMC"
system["quench"] = false
system["Dirac_operator"] = "Staggered"
system["BoundaryCondition"] = [1, 1, 1, -1]
system["log_dir"] = "./logs"
system["logfile"] = "staggered.txt"
system["saveU_dir"] = "./confs"
system["saveU_format"] = "ILDG"
system["saveU_every"] = 5
system["verboselevel"] = 2
system["randomseed"] = 7
staggered["mass"] = 0.3
staggered["Nf"] = 2
md["MDsteps"] = 20
md["Δτ"] = 1/md["MDsteps"]
md["SextonWeingargten"] = true
md["N_SextonWeingargten"] = 4 ÷ 2
cg["eps"] = 1e-16
measurement["measurement_basedir"] = "./measurements"
measurement["measurement_dir"] = "staggered"
measurement["measurement_methods"] = Dict[
  Dict{Any,Any}("methodname" => "Plaquette", "measure_every" => 1, "fermiontype" => nothing),
  Dict{Any,Any}("methodname" => "Chiral_condensate", "measure_every" => 2,
                "fermiontype" => "Staggered", "mass" => 0.3, "Nf" => 2, "Nr" => 10),
]
"""

HEATBATH_JL = """\
# quenched SU(3) heatbath with the measurements of the reference's test01.jl
system["L"] = (4, 4, 4, 4)
system["β"] = 5.7
system["NC"] = 3
system["Nthermalization"] = 0
system["Nsteps"] = 4
system["initial"] = "cold"
system["initialtrj"] = 1
system["update_method"] = "Heatbath"
system["useOR"] = true
system["numOR"] = 2
system["quench"] = true
system["Dirac_operator"] = nothing
system["log_dir"] = "./logs"
system["logfile"] = "heatbath.txt"
system["saveU_format"] = nothing
system["verboselevel"] = 1
system["randomseed"] = 111
md["MDsteps"] = 15
md["Δτ"] = 1/md["MDsteps"]
measurement["measurement_basedir"] = "./measurements"
measurement["measurement_dir"] = "heatbath"
measurement["measurement_methods"] = Array{Dict,1}(undef, 5)
for i = 1:length(measurement["measurement_methods"])
    measurement["measurement_methods"][i] = Dict()
end
measurement["measurement_methods"][1]["methodname"] = "Plaquette"
measurement["measurement_methods"][1]["measure_every"] = 1
measurement["measurement_methods"][1]["fermiontype"] = nothing
measurement["measurement_methods"][2]["methodname"] = "Polyakov_loop"
measurement["measurement_methods"][2]["measure_every"] = 1
measurement["measurement_methods"][2]["fermiontype"] = nothing
measurement["measurement_methods"][3]["methodname"] = "Topological_charge"
measurement["measurement_methods"][3]["measure_every"] = 10
measurement["measurement_methods"][3]["fermiontype"] = nothing
measurement["measurement_methods"][3]["numflow"] = 10
measurement["measurement_methods"][4]["methodname"] = "Chiral_condensate"
measurement["measurement_methods"][4]["measure_every"] = 1
measurement["measurement_methods"][4]["fermiontype"] = "Staggered"
measurement["measurement_methods"][4]["mass"] = 0.5
measurement["measurement_methods"][4]["Nf"] = 4
measurement["measurement_methods"][5]["methodname"] = "Pion_correlator"
measurement["measurement_methods"][5]["measure_every"] = 10
measurement["measurement_methods"][5]["fermiontype"] = "Wilson"
measurement["measurement_methods"][5]["hop"] = 0.141139
"""

LEGACY = {"wilson": WILSON_JL, "staggered": STAGGERED_JL, "heatbath": HEATBATH_JL}


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


# ------------------------------------------------------------------ legacy input


@pytest.mark.parametrize("kind", sorted(LEGACY))
def test_legacy_parse_and_convert_match_jax(kind, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jl = _write(tmp_path, f"{kind}.jl", LEGACY[kind])
    assert tli.parse_legacy_jl(jl) == jli.parse_legacy_jl(jl)
    assert tli.legacy_jl_to_toml_dict(jl) == jli.legacy_jl_to_toml_dict(jl)
    t_toml = tli.transform_to_toml(jl, str(tmp_path / "port.toml"))
    j_toml = jli.transform_to_toml(jl, str(tmp_path / "jax.toml"))
    with open(t_toml, "rb") as ft, open(j_toml, "rb") as fj:
        assert ft.read() == fj.read()
    # with no toml_path, the TOML goes beside the .jl file
    assert tli.transform_to_toml(jl) == str(tmp_path / f"{kind}.toml")
    pt = tp.construct_params_from_toml(t_toml, make_dirs=False)
    pj = jp.construct_params_from_toml(j_toml, make_dirs=False)
    assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
    if kind == "heatbath":
        names = {m["methodname"] for m in pt.measurement_methods}
        assert names == {"Plaquette", "Polyakov_loop", "Topological_charge",
                         "Chiral_condensate", "Pion_correlator"}
        pion = next(m for m in pt.measurement_methods if m["methodname"] == "Pion_correlator")
        assert pion["fermion_parameters"] == {"Dirac_operator": "Wilson", "hop": 0.141139}
        assert pt.quench and pt.Dirac_operator is None and pt.update_method == "Heatbath"
    if kind == "staggered":
        assert (pt.mass, pt.Nf, pt.N_SextonWeingargten, pt.dtau) == (0.3, 2, 2, 0.05)


@pytest.mark.parametrize("rhs", [
    "().__class__.__mro__[1].__subclasses__()",
    '__import__("os").getcwd()',
    'open("/etc/passwd")',
    "(lambda: 1)()",
    "[x for x in (1, 2)]",
    "md.keys()",
    "print",
])
def test_legacy_eval_is_restricted_like_jax(rhs, tmp_path):
    """The port's _safe_eval refuses what the JAX package's refuses."""
    jl = _write(tmp_path, "evil.jl", f'system["L"] = {rhs}\n')
    with pytest.raises(ValueError):
        jli.parse_legacy_jl(jl)
    with pytest.raises(ValueError):
        tli.parse_legacy_jl(jl)


def test_legacy_arithmetic_matches_jax(tmp_path):
    jl = _write(tmp_path, "ok.jl", 'md["MDsteps"] = 20\nmd["dtau"] = 1/md["MDsteps"]\n'
                                   'system["L"] = [4, 4, 4, 2*2]\nsystem["Nsteps"] = 2*3 - 7 % 4\n'
                                   'system["numOR"] = 7 ÷ 2\n')
    d = tli.parse_legacy_jl(jl)
    assert d == jli.parse_legacy_jl(jl)
    assert d["md"]["dtau"] == 0.05 and d["system"]["L"] == [4, 4, 4, 4]
    assert d["system"]["numOR"] == 3 and d["system"]["Nsteps"] == 3


# ------------------------------------------------------------------ wizard

WIZARD_CASES = {
    "quenched": dict(),
    "heatbath": dict(update_method="Heatbath", use_or=True, num_or=4, NC=2, beta=2.4),
    "wilson": dict(fermion="Wilson", hop=0.13, stout=True, stout_rho=(0.1, 0.12),
                   stout_loops=("plaquette", "plaquette"), sexton_weingarten=True, n_sw=3,
                   measurements=("Plaquette", "Pion_correlator", "Chiral_condensate",
                                 "Dirac_spectrum")),
    "staggered": dict(fermion="Staggered", mass=0.3, nf=2, stout=True, sexton_weingarten=True,
                      L=(4, 4, 4, 8), measurements=("Plaquette", "Chiral_condensate",
                                                    "Topological_charge"),
                      gradientflow_measurements=("Topological_charge", "Energy_density"),
                      saveU_format="ILDG", initial="hot"),
    "domainwall": dict(fermion="Domainwall", domainwall_L5=8, domainwall_m=0.04,
                       domainwall_M=-1.8, measurements=("Plaquette", "Pion_correlator"),
                       saveU_format="JLD", loadU_format="ILDG"),
}


@pytest.mark.parametrize("case", sorted(WIZARD_CASES))
def test_wizard_generate_matches_jax(case, tmp_path):
    kw = WIZARD_CASES[case]
    gt, gj = twz.generate_parameters(**kw), jwz.generate_parameters(**kw)
    assert gt == gj
    ft = twz.write_toml(gt, str(tmp_path / "port.toml"))
    fj = jwz.write_toml(gj, str(tmp_path / "jax.toml"))
    with open(ft, "rb") as a, open(fj, "rb") as b:
        assert a.read() == b.read()
    pt = tp.construct_params_from_toml(ft, make_dirs=False)
    assert dataclasses.asdict(pt) == dataclasses.asdict(jp.construct_params_from_toml(fj, make_dirs=False))
    assert twz.make_headername("HMC", kw.get("L", (4, 4, 4, 4)), 5.7, case) == \
        jwz.make_headername("HMC", kw.get("L", (4, 4, 4, 4)), 5.7, case)


# the answer sequences of tests/test_wizard.py's two interactive drives
INTERACTIVE = {
    "dynamical": ["4,4,4,8", "3", "5.9", "HMC", "hot", "50", "Staggered", "0.3", "2", "y",
                  "0.12,0.1", "0.04", "25", "y", "3", "1,Topological_charge,6", "2", "y", "4,3",
                  "8", "2", "0.02", "y", "ILDG", "5"],
    "heatbath": ["", "2", "2.4", "Heatbath", "", "200", "", "y", "5", "", "", "", ""],
}


@pytest.mark.parametrize("case", sorted(INTERACTIVE))
def test_interactive_wizard_matches_jax(case, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = {}
    for name, run in (("port", latticeqcd_torch.run_wizard), ("jax", jwz.run_wizard)):
        answers = iter(INTERACTIVE[case])
        monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
        fn = run(filename=str(tmp_path / f"{name}.toml"))
        assert next(answers, None) is None  # every answer taken
        with open(fn, "rb") as f:
            out[name] = f.read()
    assert out["port"] == out["jax"]


# ------------------------------------------------------------------ façade and runs


def test_facade_matches_jax_package():
    assert latticeqcd_torch.__all__ == latticeqcd_tpu.__all__
    for name in latticeqcd_torch.__all__:
        assert getattr(latticeqcd_torch, name) is not None
    # the card unless the caller names another device
    assert inspect.signature(tlqcd.run_lqcd_file).parameters["device"].default == "cuda"
    assert inspect.signature(tlqcd.run_lqcd_params).parameters["device"].default == "cuda"


def test_facade_wizard_writes_what_jax_writes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    kw = dict(interactive=False, L=(4, 4, 4, 8), beta=5.9, fermion="Wilson", hop=0.13)
    ft = latticeqcd_torch.run_wizard(filename=str(tmp_path / "port.toml"), **kw)
    fj = latticeqcd_tpu.run_wizard(filename=str(tmp_path / "jax.toml"), **kw)
    with open(ft, "rb") as a, open(fj, "rb") as b:
        assert a.read() == b.read()


def _measurement_files(tmp_path, subdir):
    d = tmp_path / "measurements" / subdir
    return {name: (d / name).read_text() for name in sorted(os.listdir(d))}


def test_jl_run_equals_its_toml_run(tmp_path, monkeypatch, capsys):
    """A .jl input through the façade (4^4 Wilson HMC, complex128, on the CPU) is
    the port's run of the TOML it was transformed to, bit for bit: the final
    plaquette and the measurement files."""
    monkeypatch.chdir(tmp_path)
    _write(tmp_path, "w.jl", WILSON_JL)
    plaq_jl = latticeqcd_torch.run_LQCD("w.jl", device="cpu")
    out = capsys.readouterr().out
    assert "input file transformed to w.toml" in out
    assert "# phase timings" in out
    update = next(line for line in out.splitlines() if line.startswith("#   update "))
    assert "(2 calls," in update
    assert out.count("Accepted") == 2  # the trajectories moved the links
    files_jl = _measurement_files(tmp_path, "wilson")
    assert len(files_jl["Plaquette.txt"].splitlines()) == 3
    plaq_toml = latticeqcd_torch.run_LQCD_file("w.toml", device="cpu", dtype=torch.complex128)
    assert plaq_toml == plaq_jl
    assert _measurement_files(tmp_path, "wilson") == files_jl
    with pytest.raises(ValueError, match="not supported"):
        latticeqcd_torch.run_LQCD(str(tmp_path / "w.yaml"), device="cpu")


def test_phase_timers_report_matches_jax():
    totals = {"update": 12.3456789, "measure": 0.5, "save": 0.0, "gradientflow": 3.25}
    counts = {"update": 10, "measure": 11, "save": 0, "gradientflow": 5}
    tt, tj = ttm.PhaseTimers(), jtm.PhaseTimers()
    for t in (tt, tj):
        t.totals.update(totals)
        t.counts.update(counts)
    assert tt.report() == tj.report()
    assert tt.report().splitlines()[1].startswith("#   update ")
    synced = []
    timers = ttm.PhaseTimers(sync=lambda: synced.append(1))
    for _ in range(3):
        with timers.phase("update"):
            pass
    with pytest.raises(RuntimeError):
        with timers.phase("measure"):
            raise RuntimeError("the phase still closes")
    assert dict(timers.counts) == {"update": 3, "measure": 1} and len(synced) == 4


def _heatbath_toml(tmp_path):
    params = twz.generate_parameters(update_method="Heatbath", nsteps=1, L=(2, 2, 2, 2),
                                     verboselevel=1, measurements=("Plaquette",))
    return twz.write_toml(params, str(tmp_path / "hb.toml"))


def test_profile_dir_writes_a_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    p = tp.construct_params_from_toml(_heatbath_toml(tmp_path), make_dirs=False)
    with ttm.torch_trace(None):  # no directory: nothing is profiled or written
        pass
    plaq = tlqcd.run_lqcd_params(p, make_dirs=False, device="cpu", profile_dir=str(tmp_path / "prof"))
    assert 0.0 < plaq < 1.0
    with open(tmp_path / "prof" / ttm.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert "# profiler trace written to" in capsys.readouterr().out


def test_run_cli_profile(tmp_path):
    toml = _heatbath_toml(tmp_path)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "latticeqcd_torch.run", toml, "--device", "cpu",
                          "--profile", "d"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "final plaquette" in out.stdout
    assert os.path.getsize(tmp_path / "d" / ttm.TRACE_FILE) > 0
    usage = subprocess.run([sys.executable, "-m", "latticeqcd_torch.run", toml, "--profile"],
                           cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert usage.returncode == 2 and "[--profile tracedir]" in usage.stdout


def test_demo_on_cpu(capsys):
    assert demo.main(["4", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "# quenched SU(3) heatbath demo: (4, 4, 4, 4) lattice, beta=5.7"
    sweeps = [line for line in lines if line.startswith("sweep ")]
    assert len(sweeps) == 4 and sweeps[-1].startswith("sweep   4  plaq=")
    assert lines[-1].startswith("# thermalized <plaq> ~ ") and len(lines) == 6
    plaqs = [float(line.split("plaq=")[1].split()[0]) for line in sweeps]
    assert all(0.0 < v < 1.0 for v in plaqs)
