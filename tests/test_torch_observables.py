"""Port parity: the gauge observables (topological charge of three kinds,
energy density, Wilson loops), the clover loops and the one-instanton
start, against the JAX package on the same links."""

import functools
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.measurements import observables as jobs  # noqa: E402
from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops import wilsonline as jwl  # noqa: E402
from latticeqcd_tpu.smearing import gradientflow as _jgf  # noqa: E402,F401
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.measurements import observables as tobs  # noqa: E402
from latticeqcd_torch.ops import fields as tfields  # noqa: E402
from latticeqcd_torch.ops import wilsonline as twl  # noqa: E402
from latticeqcd_torch.smearing import gradientflow as tgf  # noqa: E402

jgf = sys.modules["latticeqcd_tpu.smearing.gradientflow"]
to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
TOL = 1e-12


@pytest.fixture(scope="module")
def hot():
    return np.asarray(jfields.hot_start(LAT, 3, seed=41))


@pytest.mark.parametrize("kind", ["plaquette", "clover", "improved"])
def test_topological_charge_matches_jax(hot, kind):
    q_j = float(jobs.topological_charge(hot, kind))
    q_t = tobs.topological_charge(to_torch(hot), kind)
    assert q_t.dtype == torch.float64
    assert abs(q_j - float(q_t)) < TOL


def test_energy_density_matches_jax(hot):
    e_j = float(jobs.energy_density(hot))
    e_t = float(tobs.energy_density(to_torch(hot)))
    assert e_j > 0 and abs(e_j - e_t) < TOL * e_j


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_wilson_loops_match_jax(hot, r):
    """R = 4 wraps the 4^4 lattice through the periodic roll, as in the JAX package."""
    ut = to_torch(hot)
    for t in range(1, 5):
        assert abs(float(jobs.wilson_loop_rt(hot, r, t)) - float(tobs.wilson_loop_rt(ut, r, t))) < TOL


def test_cold_links_zero_charge_unit_loops():
    u = tfields.cold_start(LAT, 3, device="cpu")
    for kind in ("plaquette", "clover", "improved"):
        assert abs(float(tobs.topological_charge(u, kind))) < 1e-10
    # E sums tr(W W) of the untraced clover sums: 1 on unit links, as in the JAX package
    assert abs(float(tobs.energy_density(u)) - 1.0) < TOL
    for r, t in [(1, 1), (2, 1), (2, 2), (4, 4)]:
        assert abs(float(tobs.wilson_loop_rt(u, r, t)) - 1.0) < TOL


def test_hot_wilson_loop_below_one(hot):
    assert abs(float(tobs.wilson_loop_rt(to_torch(hot), 1, 1))) < 1.0


@pytest.mark.parametrize("mu,nu", [(0, 1), (1, 0), (2, 3), (3, 1)])
def test_cloverloops_match_jax(mu, nu):
    j, t = jwl.make_cloverloops(mu, nu), twl.make_cloverloops(mu, nu)
    assert [x.segments for x in j] == [x.segments for x in t]
    assert jwl.make_rect(mu, nu).segments == twl.make_rect(mu, nu).segments
    assert jwl.make_rect(mu, nu, 1, 2).segments == twl.make_rect(mu, nu, 1, 2).segments


def test_clover_leaves_evaluate_as_jax(hot):
    ut = to_torch(hot)
    for line_j, line_t in zip(jwl.make_cloverloops(1, 3), twl.make_cloverloops(1, 3)):
        ref = np.asarray(jwl.evaluate_line(hot, line_j))
        assert np.abs(ref - to_numpy(twl.evaluate_line(ut, line_t))).max() < TOL


@pytest.mark.parametrize("nc,lat", [(2, (4, 4, 4, 4)), (3, (4, 4, 4, 4)), (2, (8, 8, 8, 8)),
                                    (3, (4, 6, 2, 8))])
def test_one_instanton_start_matches_jax(nc, lat):
    ref = np.asarray(jfields.one_instanton_start(lat, nc))
    got = tfields.initialize_gaugefields(nc, lat, condition="one instanton", device="cpu")
    assert got.dtype == torch.complex128 and got.device.type == "cpu"
    assert np.array_equal(ref, to_numpy(got))


def test_one_instanton_carries_unit_charge_after_flow():
    """8^4 SU(2): after 5 flow steps of 0.02 the improved charge is near 1 and
    equals the JAX package's."""
    lat = (8, 8, 8, 8)
    u_j = jgf.gradientflow(2, nflow=5, eps=0.02).flow(jfields.one_instanton_start(lat, 2))
    u_t = tgf.gradientflow(2, nflow=5, eps=0.02).flow(tfields.one_instanton_start(lat, 2,
                                                                                 device="cpu"))
    assert np.abs(np.asarray(u_j) - to_numpy(u_t)).max() < TOL
    q_t = float(tobs.topological_charge(u_t, "improved"))
    assert 0.7 < abs(q_t) < 1.4, q_t
    assert abs(float(jobs.topological_charge(u_j, "improved")) - q_t) < TOL


def test_complex64_observables_within_single_precision(hot):
    """complex64 links: 1e-5 relative (1e-4 absolute for Q) of the JAX package's
    complex128 values on the same links."""
    u64 = to_torch(hot, dtype=torch.complex64)
    for kind in ("plaquette", "clover", "improved"):
        assert abs(float(jobs.topological_charge(hot, kind))
                   - float(tobs.topological_charge(u64, kind))) < 1e-4
    e_j = float(jobs.energy_density(hot))
    assert abs(e_j - float(tobs.energy_density(u64))) < 1e-5 * e_j
    w_j = float(jobs.wilson_loop_rt(hot, 1, 1))
    assert abs(w_j - float(tobs.wilson_loop_rt(u64, 1, 1))) < 1e-5 * max(abs(w_j), 1e-2)
