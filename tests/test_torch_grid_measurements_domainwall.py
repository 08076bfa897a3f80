"""The fermionic measurements on the port's process grid, on the CPU: the domain-wall
operator (L5 = 2) on 4x4x2x4 cut along t by two processes, on
test_torch_grid_measurements.py's machinery (see there). The wall sources and the chiral
join of the walls act along s, local to a 4D site; the pion's point source lives on the
rank that holds the origin; the condensate's Z4 noise and the spectrum's per-slice start
vectors are the global fields' draws with each rank's block kept."""

import torch

torch.set_num_threads(1)

from test_torch_grid_measurements import _rank_main as _measurements_rank_main  # noqa: E402
from test_torch_grid_measurements import grid_measurement_tests  # noqa: E402

LAT = (4, 4, 2, 4)


def _rank_main(argv):
    _measurements_rank_main(argv, lattice=LAT)


(references, measurement_group, test_measurement_matches_single_process,
 test_measurement_matches_jax) = grid_measurement_tests(
    "test_torch_grid_measurements_domainwall", ["domainwall"], lattice=LAT,
    grids=[(1, 1, 1, 2)], grid_ids=["t2"])
