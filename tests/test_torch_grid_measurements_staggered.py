"""The fermionic measurements on the port's process grid, on the CPU: the staggered operator, on
test_torch_grid_measurements.py's machinery (see there)."""

import torch

torch.set_num_threads(1)

from test_torch_grid_measurements import _rank_main, grid_measurement_tests  # noqa: E402, F401

(references, measurement_group, test_measurement_matches_single_process,
 test_measurement_matches_jax) = grid_measurement_tests("test_torch_grid_measurements_staggered",
                                                        ["staggered"])
