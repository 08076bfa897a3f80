"""The heatbath and overrelaxation of the SU(2) Iwasaki action on the port's process grid,
on the CPU, on test_torch_grid_heatbath.py's machinery (see there): 4x4x4x20 cut along t by
two processes, whose second block starts at t = 10, not a multiple of the action's
colouring modulus 4."""

import numpy as np
import torch

torch.set_num_threads(1)

from latticeqcd_torch.parallel import mesh  # noqa: E402
from test_torch_grid_heatbath import IWASAKI_LAT, PES, _action, _rank_main, sweep_tests  # noqa: E402, F401

started, references, rank_group, test_sweep_matches_jax = sweep_tests(
    "test_torch_grid_heatbath_iwasaki", "iwasaki")


def test_iwasaki_block_colours_differ_from_the_blocks_own():
    """Why the grid takes the global lattice's colours: the second block of 4x4x4x20 cut
    along t starts at t = 10, which the Iwasaki action's modulus 4 does not divide, so
    masks built on the block's own extents colour its sites differently."""
    from latticeqcd_torch.updates.heatbath import _color_moduli_ext, color_masks

    act = _action("iwasaki")
    grid = mesh.ProcessGrid(PES, IWASAKI_LAT, rank=1, device="cpu")
    assert _color_moduli_ext(act.max_extent(), IWASAKI_LAT)[3] == 4 and grid.origin[3] == 10
    assert _color_moduli_ext(act.max_extent(), grid.local)[3] == 5
    glob = grid.block(torch.from_numpy(color_masks(act, IWASAKI_LAT)), lead=1).numpy()
    assert glob.shape[0] == 4 ** 4 and color_masks(act, grid.local).shape[0] == 4 ** 3 * 5
    # the block's first slice t = 10 has the global colour t mod 4 = 2
    first = np.flatnonzero(glob[:, 0, 0, 0, 0])
    assert len(first) == 1 and np.unravel_index(first[0], (4, 4, 4, 4))[3] == 2
