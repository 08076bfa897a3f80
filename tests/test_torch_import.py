"""The PyTorch port stands alone: no jax, no JAX package, and its chip
script refuses to run without a CUDA device or without the port beside it.
Also pins the port's numpy-only copies (params, gammas, rational, analysis)
to the JAX package's originals."""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "latticeqcd_torch",
    "latticeqcd_torch.run",
    "latticeqcd_torch.convert",
    "latticeqcd_torch.system.lqcd",
    "latticeqcd_torch.system.universe",
    "latticeqcd_torch.updates.hmc",
    "latticeqcd_torch.md.integrators",
    "latticeqcd_torch.ops.fermion_action",
    "latticeqcd_torch.ops.solvers",
    "latticeqcd_torch.ops.eigen",
    "latticeqcd_torch.ops.rational",
    "latticeqcd_torch.ops.dirac.wilson",
    "latticeqcd_torch.ops.dirac.wilson_kernel",
    "latticeqcd_torch.ops.dirac.wilson_window_kernel",
    "latticeqcd_torch.ops.dirac.staggered",
    "latticeqcd_torch.ops.dirac.staggered_kernel",
    "latticeqcd_torch.measurements.observables",
    "latticeqcd_torch.measurements.scheduler",
    "latticeqcd_torch.measurements.fermionic",
    "latticeqcd_torch.profile_trajectory",
    "latticeqcd_torch.io",
    "latticeqcd_torch.io.native",
    "latticeqcd_torch.io.native_ext",
    "latticeqcd_torch.io.bridge_text",
    "latticeqcd_torch.io.ildg",
    "latticeqcd_torch.io.jld2",
    "latticeqcd_torch.updates.fileloading",
    "latticeqcd_torch.updates.factory",
    "latticeqcd_torch.analysis",
    "latticeqcd_torch.validation_pbp",
    "latticeqcd_torch.validation_plaq",
    "latticeqcd_torch.updates.heatbath",
    "latticeqcd_torch.smearing.gradientflow",
    "latticeqcd_torch.smearing.stout",
    "chip_smoke",
]


def _run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in PORT_MODULES)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'latticeqcd_tpu'))\n"
        + "assert not bad, bad\n"
        + "print('clean')\n"
    )
    out = _run(["-c", code], cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_chip_smoke_fails_without_cuda():
    # no visible CUDA device, also on a machine that has one
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_params_copy_matches_jax_package(tmp_path):
    from latticeqcd_tpu.system import params as jp
    from latticeqcd_torch.system import params as tp

    assert [(f.name, f.default) for f in dataclasses.fields(tp.Params)
            if f.default is not dataclasses.MISSING] == \
        [(f.name, f.default) for f in dataclasses.fields(jp.Params)
         if f.default is not dataclasses.MISSING]
    toml = {
        "Physical setting": {"L": [4, 4, 4, 8], "β": 6.0, "initial": "hot", "Nsteps": 3},
        "Physical setting(fermions)": {"quench": False, "Dirac_operator": "Wilson",
                                       "hop": 0.141139},
        "HMC related": {"Δτ": 0.1, "MDsteps": 10, "eps": 1e-16},
        "Measurement set": {"measurement_methods": [{"methodname": "Plaquette"}]},
    }
    a = jp.construct_params_from_toml(dict(toml), make_dirs=False)
    b = tp.construct_params_from_toml(dict(toml), make_dirs=False)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_gammas_copy_matches_jax_package():
    from latticeqcd_tpu.ops.dirac import gammas as jg
    from latticeqcd_torch.ops.dirac import gammas as tg

    np.testing.assert_array_equal(jg.GAMMA, tg.GAMMA)
    np.testing.assert_array_equal(jg.GAMMA5, tg.GAMMA5)
    for a, b in zip(jg.half_spinor_factors(), tg.half_spinor_factors()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jg.projectors(0.5), tg.projectors(0.5)):
        np.testing.assert_array_equal(a, b)


def test_rational_copy_matches_jax_package():
    """The copy's code is the original's below the module docstring, and it
    gives the same coefficients."""
    from latticeqcd_tpu.ops import rational as jr
    from latticeqcd_torch.ops import rational as tr

    def body(mod):
        src = open(mod.__file__).read()
        return src[src.index("from __future__ import annotations"):]

    assert body(jr) == body(tr)
    for beta in (0.25, 0.5, 0.75, 1.25):
        a, b = jr.rational_inverse_power(beta, 0.1, 20.0), tr.rational_inverse_power(beta, 0.1, 20.0)
        assert (a.const, a.residues, a.shifts) == (b.const, b.residues, b.shifts)


def test_analysis_copy_matches_jax_package():
    """The copy's code is the original's below the module docstring (with the
    package's own name in its CLI text), and it gives the same numbers on
    seeded series."""
    from latticeqcd_tpu import analysis as ja
    from latticeqcd_torch import analysis as ta

    def body(mod):
        src = open(mod.__file__).read()
        return src[src.index("from __future__ import annotations"):]

    assert body(ja).replace("latticeqcd_tpu", "latticeqcd_torch") == body(ta)
    rng = np.random.default_rng(12)
    ar1 = np.zeros(4000)
    for i in range(1, len(ar1)):
        ar1[i] = 0.8 * ar1[i - 1] + rng.normal()
    for series in (rng.normal(size=300), ar1, rng.normal(size=5)):
        assert ja.autocorrelation(series) == ta.autocorrelation(series)
        assert ja.jackknife(series[: len(series) // 10 * 10 or None], nblocks=5) == \
            ta.jackknife(series[: len(series) // 10 * 10 or None], nblocks=5)
    corr = np.cosh(0.4 * (np.arange(16) - 8.0)) + 1e-3 * rng.random(16)
    np.testing.assert_array_equal(ja.effective_mass(corr), ta.effective_mass(corr))
