"""Stout smearing as a stack of layers.

Counterpart of latticeqcd_tpu/smearing/stout.py. Each layer is the
Morningstar-Peardon map

    U'_mu = exp(i Q_mu) U_mu,  Q_mu = proj_TH(i U_mu V_mu),

with V_mu the staple sum of the layer's loop set (and its adjoints)
weighted by rho. The stack is plain differentiable PyTorch: the chain
rule of the fermion force through the smearing is torch.autograd.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from latticeqcd_torch.ops import sun, wilsonline
from latticeqcd_torch.ops.wilsonline import make_loops_fromname

DIRS = 4


@dataclass(frozen=True)
class StoutLayer:
    """One stout layer: a loop set and one rho for all its loops."""

    rho: float
    loop_names: Tuple[str, ...] = ("plaquette",)

    def _weighted_lines(self, dim=4):
        lines = []
        for name in self.loop_names:
            for line in make_loops_fromname(name, dim):
                lines.append((self.rho, line))
                lines.append((self.rho, line.adjoint()))
        return lines

    def smear(self, u: torch.Tensor) -> torch.Tensor:
        lines = self._weighted_lines()
        out = []
        for mu in range(DIRS):
            v = wilsonline.staple_sum(u, lines, mu)
            q = sun.traceless_hermitian(1j * sun.mul(u[mu], v))
            out.append(sun.mul(sun.expi_hermitian(q, 1.0), u[mu]))
        return torch.stack(out, dim=0)


@dataclass(frozen=True)
class CovNet:
    """A stack of stout layers, applied in order."""

    layers: Tuple[StoutLayer, ...]

    def smear(self, u: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            u = layer.smear(u)
        return u


def stout_stack(rhos, loop_names=("plaquette",)) -> CovNet:
    """A CovNet of one layer per rho."""
    return CovNet(tuple(StoutLayer(float(r), tuple(loop_names)) for r in rhos))
