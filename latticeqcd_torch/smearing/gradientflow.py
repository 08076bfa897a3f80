"""The Wilson gradient flow (Luescher's RK3).

Counterpart of latticeqcd_tpu/smearing/gradientflow.py: dU/dt = i H_fl U
with H_fl the gauge force of the flow action, the plaquette action at
beta = 2 NC (the heat-kernel normalisation: a weak field decays as
exp(-p_hat^2 t)), integrated by Luescher's three-stage Runge-Kutta
scheme, one step per eps, on the port's gauge_action.force and
md.integrators.update_links.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from latticeqcd_torch.md.integrators import update_links
from latticeqcd_torch.ops import gauge_action as ga


def wilson_flow_action(nc: int) -> ga.GaugeAction:
    """The heat-kernel-normalised plaquette flow action (beta_flow = 2 NC)."""
    return ga.wilson_gauge_action(nc, 2.0 * nc)


@dataclass(frozen=True)
class GradientFlow:
    """nflow RK3 steps of size eps per call of ``flow``."""

    action: ga.GaugeAction
    eps: float = 0.01
    nflow: int = 1

    @torch.no_grad()
    def flow(self, u: torch.Tensor) -> torch.Tensor:
        def z(uu):
            return self.eps * ga.force(self.action, uu)

        for _ in range(self.nflow):
            z0 = z(u)
            w1 = update_links(u, z0, 0.25)
            z1 = z(w1)
            w2 = update_links(w1, (8.0 / 9.0) * z1 - (17.0 / 36.0) * z0, 1.0)
            z2 = z(w2)
            u = update_links(w2, 0.75 * z2 - (8.0 / 9.0) * z1 + (17.0 / 36.0) * z0, 1.0)
        return u


def gradientflow(u_or_nc, nflow: int = 1, eps: float = 0.01,
                 action: Optional[ga.GaugeAction] = None) -> GradientFlow:
    """The flow of ``action`` (by default the Wilson flow action for the
    links' NC, or for NC given as an int)."""
    if action is None:
        nc = u_or_nc if isinstance(u_or_nc, int) else u_or_nc.shape[-1]
        action = wilson_flow_action(nc)
    return GradientFlow(action=action, eps=eps, nflow=nflow)
