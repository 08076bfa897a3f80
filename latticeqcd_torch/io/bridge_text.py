"""Bridge++ plain-text gauge-configuration I/O.

Counterpart of latticeqcd_tpu/io/bridge_text.py, with the same line
ordering and the same bytes on save: one float per line (``repr`` of
the float64), 2 * NC*NC * 4 * V lines; site-major with x fastest (t
slowest), then direction mu = x, y, z, t, then colour row a, then
colour column b, re before im.
"""

from __future__ import annotations

import numpy as np
import torch

from latticeqcd_torch.io import native_ext
from latticeqcd_torch.io.native import host_array, to_links

DIRS = 4


def load_bridge_text(filename, lattice, nc: int, dtype=torch.complex128,
                     device="cuda") -> torch.Tensor:
    """Load a Bridge++ text config into U[mu, x, y, z, t, a, b] on ``device``."""
    nx, ny, nz, nt = lattice
    expected = 2 * nc * nc * DIRS * nx * ny * nz * nt
    data = native_ext.parse_text_doubles(filename, expected)
    if data.size != expected:
        raise ValueError(
            f"{filename}: got {data.size} values, expected {expected} "
            f"for lattice {lattice} NC={nc}"
        )
    cplx = native_ext.to_complex(data)
    # file order: t slowest, then z, y, x, then mu, row a, col b
    arr = cplx.reshape(nt, nz, ny, nx, DIRS, nc, nc)
    # -> (mu, x, y, z, t, a, b)
    return to_links(np.transpose(arr, (4, 3, 2, 1, 0, 5, 6)), dtype, device)


def save_bridge_text(filename, u) -> None:
    """Save U[mu, x, y, z, t, a, b] in the same line ordering."""
    # -> (t, z, y, x, mu, a, b)
    arr = np.transpose(host_array(u), (4, 3, 2, 1, 0, 5, 6))
    flat = arr.reshape(-1)
    out = np.empty(2 * flat.size, dtype=np.float64)
    out[0::2] = flat.real
    out[1::2] = flat.imag
    with open(filename, "w") as fp:
        fp.write("\n".join(repr(float(v)) for v in out))
        fp.write("\n")
