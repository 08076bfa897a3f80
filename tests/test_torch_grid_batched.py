"""Batched chains (HMC.step_batched) on the port's process grid, on the CPU.

One group of two gloo processes (test_torch_grid's start_ranks, one torch
thread each), started before the references are computed here:

* the chains split over the two ranks (make_process_grid with two chain
  groups over an uncut 4^4 lattice): 4 complex128 Wilson chains, 2 per
  rank, each rank given the generators of all 4 and running its own,
  against one process's step_batched over the 4 (dH 1e-10, links 1e-12,
  the bars of tests/test_torch_batched.py); 4 quenched chains (the setup
  of tests/test_collective_audit.py's chain-sharded audit: beta 5.7,
  dtau 0.05, 3 MD steps) from the JAX package's own keys, each rank
  replaying its chains' draws through test_torch_hmc.jax_draws, against
  the JAX package's step_batched per chain;
* the lattice cut over the two ranks (the grid (1, 1, 1, 2) over
  4x4x4x8) with 2 complex128 Wilson chains: the chain-halo form of the
  packed hop, every face exchange carrying both chains, against one
  process's step_batched (dH 1e-8, links 1e-10), every rank's dH and
  decisions bitwise the same;
* one complex128 Wilson trajectory with md_precision = "mixed" on the
  same grid against one process (dH 1e-8, links 1e-10).

The other Wilson-family actions and staggered on the grid are in
test_torch_grid_batched_fermions.py; both layouts at once, and the
messages of each, in test_torch_grid_audit.py.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_torch.parallel import mesh  # noqa: E402
from test_torch_grid import rank_main, start_ranks  # noqa: E402

PES = (1, 1, 1, 2)
LAT = (4, 4, 4, 8)  # the lattice grid's
SPLIT_LAT = (4, 4, 4, 4)  # the chain split's
NCHAIN = 4
SPLIT_SEEDS = (31, 32, 33, 34)
GRID_SEEDS = (41, 42)
QUENCHED = dict(dtau=0.05, md_steps=3)
JAX_SEEDS = tuple(range(8, 8 + NCHAIN))  # hot starts and keys of the JAX chains


def _hmc(kind):
    from latticeqcd_torch.ops import gauge_action as ga
    from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
    from latticeqcd_torch.ops.fermion_action import WilsonFermiAction
    from latticeqcd_torch.updates.hmc import HMC

    if kind == "quenched":
        return HMC(action=ga.wilson_gauge_action(3, 5.7), **QUENCHED)
    fa = WilsonFermiAction(WilsonDirac(kappa=0.141139), eps_cg=1e-22)
    return HMC(action=ga.wilson_gauge_action(3, 5.7), dtau=0.1, md_steps=2, fermi_action=fa,
               md_precision="mixed" if kind == "mixed" else "auto")


def _chains(lat, seeds):
    """The chains' links: this rank's block under a lattice grid."""
    from latticeqcd_torch.ops import fields

    return torch.stack([fields.hot_start(lat, 3, seed=s, device="cpu") for s in seeds])


def _generators(seeds):
    return [torch.Generator().manual_seed(100 + s) for s in seeds]


def _stats(st, prefix):
    return {f"{prefix}_dh": st["dH"].numpy(), f"{prefix}_accepted": st["accepted"].numpy()}


def _jax_draws(seeds):
    """The JAX package's draws of each quenched chain from its own key, replayed on the
    CPU (the JAX package imported here, in a test process)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from latticeqcd_tpu.ops import fields as jfields
    from test_torch_hmc import jax_draws

    return [jax_draws(jax.random.PRNGKey(s), jfields.hot_start(SPLIT_LAT, 3, seed=s))
            for s in seeds]


def _case_batched(grid):
    out = {}
    # the chains split over the ranks: each rank its share of the 4, on the whole lattice
    split = mesh.make_process_grid((1, 1, 1, 1), SPLIT_LAT, "cpu", chain_groups=2)
    with mesh.use_grid(split):
        share = mesh.chain_share(list(SPLIT_SEEDS))
        u, st = _hmc("wilson").step_batched(_chains(SPLIT_LAT, share),
                                            _generators(SPLIT_SEEDS))
        out.update(_stats(st, "split"), split_u=u.numpy(), split_seeds=np.array(share))
        draws = _jax_draws(JAX_SEEDS)
        u, st = _hmc("quenched").step_batched(_chains(SPLIT_LAT, mesh.chain_share(list(JAX_SEEDS))),
                                              draws=draws)
        out.update(_stats(st, "jax"), jax_u=u.numpy())
    # the lattice cut over the ranks, two chains
    u, st = _hmc("wilson").step_batched(_chains(LAT, GRID_SEEDS), _generators(GRID_SEEDS))
    out.update(_stats(st, "grid"), grid_u=mesh.to_host_global(u, lead=2, all_ranks=True))
    # one mixed-MD trajectory (a single chain) on the grid
    u, st = _hmc("mixed").step(_chains(LAT, (43,))[0], torch.Generator().manual_seed(44))
    out.update(mixed_dh=np.asarray(st["dH"]), mixed_accepted=np.asarray(st["accepted"]),
               mixed_u=mesh.to_host_global(u, lead=1, all_ranks=True))
    return out


def _rank_main(argv):
    rank_main(argv, {"batched": _case_batched}, lattice=LAT)


# ------------------------------------------------- references, in the parent


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    out = tmp_path_factory.mktemp("grid_batched")
    started = start_ranks("test_torch_grid_batched", "batched", PES, out)
    yield started
    started.kill()


@pytest.fixture(scope="module")
def references(group):
    """One process's results (and the JAX package's), computed while the ranks run."""
    import jax
    import jax.numpy as jnp

    from latticeqcd_tpu.ops import fields as jfields
    from latticeqcd_tpu.ops import gauge_action as jga
    from latticeqcd_tpu.updates.hmc import HMC as JHMC

    ref = {}
    u, st = _hmc("wilson").step_batched(_chains(SPLIT_LAT, SPLIT_SEEDS), _generators(SPLIT_SEEDS))
    ref.update(_stats(st, "split"), split_u=u.numpy())
    u, st = _hmc("wilson").step_batched(_chains(LAT, GRID_SEEDS), _generators(GRID_SEEDS))
    ref.update(_stats(st, "grid"), grid_u=u.numpy())
    u, st = _hmc("mixed").step(_chains(LAT, (43,))[0], torch.Generator().manual_seed(44))
    ref.update(mixed_dh=np.asarray(st["dH"]), mixed_accepted=np.asarray(st["accepted"]),
               mixed_u=u.numpy())
    uj = jnp.stack([jfields.hot_start(SPLIT_LAT, 3, seed=s) for s in JAX_SEEDS])
    keys = jnp.stack([jax.random.PRNGKey(s) for s in JAX_SEEDS])
    u_j, _, st_j = JHMC(action=jga.wilson_gauge_action(3, 5.7), staged=False,
                        **QUENCHED).step_batched(uj, keys)
    ref.update(jax_dh=np.asarray(st_j["dH"]), jax_accepted=np.asarray(st_j["accepted"]),
               jax_u=np.asarray(u_j))
    return ref


@pytest.fixture(scope="module")
def ranks(group, references):
    return group.join()


# ------------------------------------------------------------------- tests


def _share(rank):
    return slice(rank * NCHAIN // 2, (rank + 1) * NCHAIN // 2)


def test_chain_split_equals_one_process(ranks, references):
    """Each rank runs its 2 of the 4 Wilson chains from the generators of all 4: per chain
    the dH, the decision and the links of one process's step_batched over the 4."""
    for rank, res in enumerate(ranks):
        sl = _share(rank)
        assert res["split_seeds"].tolist() == list(SPLIT_SEEDS[sl]), rank
        assert np.abs(res["split_dh"] - references["split_dh"][sl]).max() < 1e-10, rank
        assert np.array_equal(res["split_accepted"], references["split_accepted"][sl]), rank
        assert np.abs(res["split_u"] - references["split_u"][sl]).max() < 1e-12, rank


def test_quenched_chain_split_matches_jax_step_batched(ranks, references):
    """The quenched chains split over the ranks from the JAX package's keys, each rank's
    chains against the JAX package's step_batched over all 4 (dH 1e-9, links 1e-12, the
    bars of tests/test_torch_batched.py's quenched case)."""
    assert references["jax_accepted"].all()  # evolved links are compared
    for rank, res in enumerate(ranks):
        sl = _share(rank)
        assert np.abs(res["jax_dh"] - references["jax_dh"][sl]).max() < 1e-9, rank
        assert np.array_equal(res["jax_accepted"], references["jax_accepted"][sl]), rank
        assert np.abs(res["jax_u"] - references["jax_u"][sl]).max() < 1e-12, rank


def test_lattice_grid_batched_wilson_equals_one_process(ranks, references):
    """Two Wilson chains on the lattice cut in two along t: per chain dH 1e-8 and links
    1e-10 against one process's step_batched, the decisions the same, every rank's dH
    bitwise equal."""
    res = ranks[0]
    assert np.abs(res["grid_dh"] - references["grid_dh"]).max() < 1e-8
    assert np.array_equal(res["grid_accepted"], references["grid_accepted"])
    assert np.abs(res["grid_u"] - references["grid_u"]).max() < 1e-10
    assert ranks[1]["grid_dh"].tobytes() == res["grid_dh"].tobytes()
    assert np.array_equal(ranks[1]["grid_u"], res["grid_u"])


def test_mixed_md_on_the_grid_equals_one_process(ranks, references):
    """A single-chain Wilson trajectory with md_precision = "mixed" (the MD state lifted to
    complex128 on each block) on two ranks against one process: dH 1e-8, links 1e-10, the
    same decision, both ranks' dH bitwise equal."""
    res = ranks[0]
    assert abs(float(res["mixed_dh"]) - float(references["mixed_dh"])) < 1e-8
    assert bool(res["mixed_accepted"]) == bool(references["mixed_accepted"])
    assert np.abs(res["mixed_u"] - references["mixed_u"]).max() < 1e-10
    assert ranks[1]["mixed_dh"].tobytes() == res["mixed_dh"].tobytes()
