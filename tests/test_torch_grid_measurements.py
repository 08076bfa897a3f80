"""The fermionic measurements on the port's process grid, on the CPU: the Wilson operator
here, the clover, staggered and domain-wall ones in test_torch_grid_measurements_clover.py,
test_torch_grid_measurements_staggered.py and test_torch_grid_measurements_domainwall.py, on
this module's machinery.

Each grid over 4^4 (the domain-wall one over 4x4x2x4) runs as a group of gloo
processes (test_torch_grid's run_ranks). For each operator:

* Chiral_condensate, Pion_correlator and Dirac_spectrum through the
  measurement scheduler, their noise and start vector drawn from the
  run's generators (the global fields' draws, each rank keeping its
  block), against the single-process port to 1e-12 and bitwise the same
  on every rank;
* the same three functions fed the JAX package's own draws (its Z4
  integers and its Lanczos start vector, global arrays cut to each
  rank's block; the pion correlator draws nothing) against the JAX
  package's functions, to the bars of tests/test_torch_measurements.py.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from test_torch_grid import GRID_IDS, GRIDS, rank_main, run_ranks  # noqa: E402

LAT = (4, 4, 4, 4)
EPS = 1e-22
NR, NEIG, NLANCZOS = 2, 3, 24
# operator -> fermion_parameters
OPERATORS = {
    "wilson": {"Dirac_operator": "Wilson", "hop": 0.12},
    "clover": {"Dirac_operator": "WilsonClover", "hop": 0.12, "Clover_coefficient": 1.0},
    "staggered": {"Dirac_operator": "Staggered", "mass": 0.5, "Nf": 4},
    "domainwall": {"Dirac_operator": "Domainwall", "Domainwall_m": 0.3, "Domainwall_M": -1.8,
                   "Domainwall_L5": 2},
}
METHODS = ["Chiral_condensate", "Pion_correlator", "Dirac_spectrum"]
SEED, KEY = 31, 32


def _nspin(op):
    return 1 if op == "staggered" else 4


def _links(lattice):
    from latticeqcd_torch.ops import fields

    return fields.hot_start(lattice, 3, seed=SEED, device="cpu")  # the block under a grid


def _scheduled(u, ops):
    """Each method on each operator of ``ops`` through the scheduler (generator draws)."""
    from latticeqcd_torch.measurements.scheduler import MeasurementSet

    out = {}
    for op in ops:
        methods = [{"methodname": m, "fermion_parameters": OPERATORS[op], "eps": EPS, "Nr": NR,
                    "Neig": NEIG, "Nlanczos": NLANCZOS} for m in METHODS]
        for m, meas in zip(METHODS, MeasurementSet.from_methods(methods).measurements):
            meas.measure(u, 1)
            value = [meas.value[0], *meas.value[1]] if m == "Chiral_condensate" else meas.value
            out[f"sched_{op}_{m}"] = np.asarray(value, dtype=np.float64)
    return out


def _injected(u, z, block, ops):
    """The condensate and the spectrum on each operator of ``ops`` fed the JAX package's
    draws; ``block`` cuts a global field (lattice axes from the given one) to the fields'
    lattice. The pion correlator draws nothing: the scheduler's value is the one compared."""
    from latticeqcd_torch.measurements import fermionic
    from latticeqcd_torch.measurements.scheduler import build_dirac_from_params

    out = {}
    for op in ops:
        fparams = OPERATORS[op]
        d = build_dirac_from_params(fparams, tuple(u.shape[1:5]))
        nf = 0.25 * fparams["Nf"] if op == "staggered" else 1.0
        pbp, vals = fermionic.chiral_condensate(u, d, nr=NR, nf_factor=nf, eps=EPS,
                                                draws=block(z[f"z4_{op}"], 1))
        out[f"jaxdraws_{op}_Chiral_condensate"] = np.array([pbp] + vals)
        v0 = z[f"v0_{op}"]  # domain wall: one 4D field per slice s
        out[f"jaxdraws_{op}_Dirac_spectrum"] = fermionic.dirac_low_spectrum(
            u, d, k=NEIG, m=NLANCZOS, v0=torch.from_numpy(block(v0, int(op == "domainwall"))))
    return out


def _measure(block, draws_file, lattice, ops):
    u = _links(lattice)
    out = _scheduled(u, ops)
    out.update(_injected(u, dict(np.load(draws_file)), block, ops))
    for op in ops:
        out[f"jaxdraws_{op}_Pion_correlator"] = out[f"sched_{op}_Pion_correlator"]
    return out


def _case_measurements(grid, draws_file, *ops):
    return _measure(lambda a, lead: grid.block(a, lead).copy(), draws_file, grid.lattice, ops)


def _rank_main(argv, lattice=LAT):
    rank_main(argv, {"measurements": _case_measurements}, lattice=lattice)


# ------------------------------------------------- references, in the parent


def _references(tmp_path_factory, ops, lattice):
    """The JAX package's measurements on its own draws, the draws (written for the rank
    groups), and the single-process port's results, for the operators ``ops``."""
    import jax

    from latticeqcd_tpu.measurements import fermionic as jferm
    from latticeqcd_tpu.ops import fields as jfields
    from latticeqcd_tpu.ops.dirac import staggered as js
    from latticeqcd_tpu.ops.dirac import wilson as jw
    from latticeqcd_tpu.ops.dirac.domainwall import DomainwallDirac as JD
    from test_torch_measurements import _z4_draws

    u = jfields.hot_start(lattice, 3, seed=SEED)
    key = jax.random.PRNGKey(KEY)
    draws, jax_out = {}, {}
    for op in ops:
        fp = OPERATORS[op]
        v0 = np.asarray(jw.gaussian_spinor(jax.random.PRNGKey(20260822), lattice, 3,
                                           nspin=_nspin(op)))
        if op == "staggered":
            d, nf = js.StaggeredDirac(mass=fp["mass"], lattice=lattice), 0.25 * fp["Nf"]
        elif op == "domainwall":
            d, nf = JD(fp["Domainwall_m"], fp["Domainwall_M"], fp["Domainwall_L5"]), 1.0
            v0 = np.stack([np.asarray(jw.gaussian_spinor(jax.random.PRNGKey(20260822 + s),
                                                         lattice, 3))
                           for s in range(fp["Domainwall_L5"])])
        else:
            d, nf = jw.WilsonDirac(kappa=fp["hop"], csw=fp.get("Clover_coefficient", 0.0)), 1.0
        pbp, vals = jferm.chiral_condensate(u, d, key, nr=NR, nf_factor=nf, eps=EPS)
        jax_out[f"{op}_Chiral_condensate"] = np.array([float(pbp)] + [float(v) for v in vals])
        jax_out[f"{op}_Pion_correlator"] = np.asarray(jferm.pion_correlator(u, d, eps=EPS))
        jax_out[f"{op}_Dirac_spectrum"] = np.asarray(jferm.dirac_low_spectrum(u, d, k=NEIG,
                                                                              m=NLANCZOS))
        draws[f"z4_{op}"] = _z4_draws(key, lattice, 3, _nspin(op), NR)
        draws[f"v0_{op}"] = v0
    draws_file = os.path.join(tmp_path_factory.mktemp("grid_measurements"), "draws.npz")
    np.savez(draws_file, **draws)
    return draws_file, _measure(lambda a, lead: a, draws_file, lattice, ops), jax_out


def grid_measurement_tests(module, ops, lattice=LAT, grids=GRIDS, grid_ids=GRID_IDS):
    """(the references fixture, the rank-group fixture, and the two tests) of a module that
    measures the operators ``ops`` on ``lattice`` under the ``grids``: one operator per
    module, so that each rank group stays small and loadfile spreads the operators over the
    workers."""

    @pytest.fixture(scope="module")
    def references(tmp_path_factory):
        return _references(tmp_path_factory, ops, lattice)

    @pytest.fixture(scope="module", params=grids, ids=grid_ids)
    def measurement_group(request, references, tmp_path_factory):
        out = tmp_path_factory.mktemp("grid_measurements_ranks")
        return request.param, run_ranks(module, "measurements", request.param, out,
                                        references[0], *ops)

    cases = [(op, m) for op in ops for m in METHODS]
    ids = [f"{op}-{m}" for op, m in cases]

    @pytest.mark.parametrize("op,method", cases, ids=ids)
    def test_measurement_matches_single_process(measurement_group, references, op, method):
        """The scheduler's measurement under the grid (global noise and start vector, halo
        kernels, global sums) against one process to 1e-12 of its size, the same on every
        rank bit for bit."""
        pes, ranks = measurement_group
        key = f"sched_{op}_{method}"
        want = references[1][key]
        assert (np.abs(ranks[0][key] - want) <= 1e-12 * np.maximum(np.abs(want), 1.0)).all(), pes
        for res in ranks[1:]:
            assert res[key].tobytes() == ranks[0][key].tobytes(), (pes, key)

    @pytest.mark.parametrize("op,method", cases, ids=ids)
    def test_measurement_matches_jax(measurement_group, references, op, method):
        """The measurement under the grid fed the JAX package's Z4 integers and start vector
        (each rank its block) against the JAX package's function, and against one process
        fed the same global draws."""
        pes, ranks = measurement_group
        key = f"jaxdraws_{op}_{method}"
        rtol = 1e-8 if method == "Dirac_spectrum" else 1e-9
        np.testing.assert_allclose(ranks[0][key], references[2][f"{op}_{method}"], rtol=rtol)
        want = references[1][key]
        assert (np.abs(ranks[0][key] - want) <= 1e-12 * np.maximum(np.abs(want), 1.0)).all(), pes
        for res in ranks[1:]:
            assert res[key].tobytes() == ranks[0][key].tobytes(), (pes, key)

    return references, measurement_group, test_measurement_matches_single_process, \
        test_measurement_matches_jax


(references, measurement_group, test_measurement_matches_single_process,
 test_measurement_matches_jax) = grid_measurement_tests("test_torch_grid_measurements", ["wilson"])
