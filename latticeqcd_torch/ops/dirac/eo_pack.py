"""Even-odd (checkerboard) packing for Dirac stencils.

Counterpart of latticeqcd_tpu/ops/dirac/eo_pack.py, same layout:
parity-p sites of row (y,z,t) are stored with the x axis halved,
x = 2x' + s, where the row offset s(y,z,t) is rho for even and 1-rho for
odd, rho = (y+z+t) mod 2. Hops along mu != 0 are plain rolls; x hops
are a row-parity select between a field and its roll:

  source sites x = 2x' + s_t (target offset s_t, source offset 1-s_t):
    +x:  x+1 = 2(x'+s_t) + (1-s_t)   ->  x'' = x' + s_t
    -x:  x-1 = 2(x'+s_t-1) + (1-s_t) ->  x'' = x' - (1-s_t)

Every lattice extent must be even. The row fields are numpy (static);
they become boolean masks on the field's device where they are used.
"""

from __future__ import annotations

import numpy as np
import torch

from latticeqcd_torch.ops import rolls

DIRS = 4


def rho_field(lattice) -> np.ndarray:
    """Row parity rho(y,z,t) in {0,1}."""
    ly, lz, lt = lattice[1:]
    gy, gz, gt = np.meshgrid(np.arange(ly), np.arange(lz), np.arange(lt), indexing="ij")
    return (gy + gz + gt) % 2


def offset_field(lattice, parity: int) -> np.ndarray:
    """Packed-row offset s(y,z,t) for parity 0=even, 1=odd."""
    rho = rho_field(lattice)
    return rho if parity == 0 else 1 - rho


_MASKS: dict = {}


def _mask(s: np.ndarray, ndim_after: int, device, lead: int = 1) -> torch.Tensor:
    """Boolean (Y,Z,T) row field on ``device``, shaped to broadcast as
    (1,)*lead + (Y,Z,T) + (1,)*ndim_after. Each row field is copied to a
    device once, so a hop issues no host-to-device copy (and can be
    captured in a CUDA graph)."""
    key = (s.shape, s.tobytes(), str(device))
    if key not in _MASKS:
        _MASKS[key] = torch.as_tensor(s.astype(bool), device=device)
    return _MASKS[key].reshape((1,) * lead + s.shape + (1,) * ndim_after)


def pack(f: torch.Tensor, lattice, parity: int) -> torch.Tensor:
    """Full site field (X,Y,Z,T,...) -> packed (X/2,Y,Z,T,...)."""
    f2 = f.reshape((lattice[0] // 2, 2) + tuple(f.shape[1:]))
    b = _mask(offset_field(lattice, parity), f.ndim - 4, f.device)
    return torch.where(b, f2[:, 1], f2[:, 0])


def unpack(fp: torch.Tensor, lattice, parity: int) -> torch.Tensor:
    """Packed parity field -> full field, zero on the other parity."""
    b = _mask(offset_field(lattice, parity), fp.ndim - 4, fp.device)
    zero = torch.zeros_like(fp)
    f2 = torch.stack([torch.where(b, zero, fp), torch.where(b, fp, zero)], dim=1)
    return f2.reshape((lattice[0],) + tuple(fp.shape[1:]))


def pack_links(u: torch.Tensor, lattice):
    """(U_even, U_odd): links packed by base-site parity, each
    (4, X/2, Y, Z, T, NC, NC). Differentiable (a select)."""
    u2 = u.reshape((DIRS, lattice[0] // 2, 2) + tuple(u.shape[2:]))
    b = _mask(rho_field(lattice), u.ndim - 5, u.device, lead=2)
    even = torch.where(b, u2[:, :, 1], u2[:, :, 0])
    odd = torch.where(b, u2[:, :, 0], u2[:, :, 1])
    return even, odd


def gather_plus(f: torch.Tensor, mu: int, s_t: np.ndarray) -> torch.Tensor:
    """f^src(x + mu) seen from target sites x = 2x' + s_t."""
    if mu == 0:
        return torch.where(_mask(s_t, f.ndim - 4, f.device), rolls.roll(f, -1, 0), f)
    return rolls.roll(f, -1, mu)


def gather_minus(f: torch.Tensor, mu: int, s_t: np.ndarray) -> torch.Tensor:
    """f^src(x - mu) seen from target sites x = 2x' + s_t."""
    if mu == 0:
        return torch.where(_mask(s_t, f.ndim - 4, f.device), f, rolls.roll(f, 1, 0))
    return rolls.roll(f, 1, mu)


def scatter_minus(g: torch.Tensor, mu: int, s_t: np.ndarray) -> torch.Tensor:
    """Adjoint of gather_minus: moves values held at target sites x back
    onto the source sites x - mu they were gathered from."""
    if mu == 0:
        b = _mask(s_t, g.ndim - 4, g.device)
        zero = torch.zeros_like(g)
        return torch.where(b, g, zero) + rolls.roll(torch.where(b, zero, g), -1, 0)
    return rolls.roll(g, -1, mu)


def packable(lattice) -> bool:
    return all(l % 2 == 0 for l in lattice)
