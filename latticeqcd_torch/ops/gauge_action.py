"""Wilson plaquette gauge action: value, staples, HMC force, plaquette.

Counterpart of latticeqcd_tpu/ops/gauge_action.py with the reference's
conventions: the Wilson action is the plaquette loops plus their
adjoints at coupling beta/2, S_g = -Re evaluate(U) / NC. Staples and
forces use the fused 6-staple form; actions with other loops (rect,
chair, user loops) wait for a later slice and raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from latticeqcd_torch.ops import sun, wilsonline
from latticeqcd_torch.ops.wilsonline import make_loops_fromname

DIRS = 4


@dataclass(frozen=True)
class GaugeAction:
    """Immutable list of (coupling, (Wilsonline, ...)) terms; plaq_coeff
    records the coupling when the action is exactly the Wilson one."""

    nc: int
    terms: tuple = ()
    plaq_coeff: float = 0.0

    def push(self, coeff: float, loops) -> "GaugeAction":
        return GaugeAction(self.nc, self.terms + ((float(coeff), tuple(loops)),), 0.0)

    def max_extent(self) -> int:
        """Largest |offset| any loop reaches: sets the heatbath's colouring."""
        return max([1] + [max(abs(x) for x in o) for _, loops in self.terms for line in loops
                          for o in wilsonline.path_offsets(line.expand())])


def wilson_gauge_action(nc: int, beta: float, dim: int = 4) -> GaugeAction:
    """Plaquette loops + adjoints at coupling beta/2."""
    plaq = make_loops_fromname("plaquette", dim)
    loops = list(plaq) + [l.adjoint() for l in plaq]
    act = GaugeAction(nc).push(beta / 2, loops)
    return GaugeAction(act.nc, act.terms, plaq_coeff=beta / 2)


def evaluate(action: GaugeAction, u: torch.Tensor) -> torch.Tensor:
    """sum_i c_i sum_x sum_loops tr W (complex)."""
    total = 0.0
    for coeff, loops in action.terms:
        total = total + coeff * wilsonline.evaluate_loop_trace_sum(u, loops)
    return total


def action_value(action: GaugeAction, u: torch.Tensor) -> torch.Tensor:
    """S_g = -Re evaluate(U) / NC."""
    return -torch.real(evaluate(action, u)) / action.nc


def _unit(mu, sign=1):
    e = [0] * DIRS
    e[mu] = sign
    return e


def _plaquette_staple(u: torch.Tensor, mu: int) -> torch.Tensor:
    """A_mu(y) = sum_{nu != mu} of the forward and backward staples:

      fwd: U_nu(y+mu) U_mu(y+nu)^dag U_nu(y)^dag
      bwd: U_nu(y+mu-nu)^dag U_mu(y-nu)^dag U_nu(y-nu)
    """
    total = 0.0
    for nu in range(DIRS):
        if nu == mu:
            continue
        unu = u[nu]
        umu = u[mu]
        unu_pmu = wilsonline._roll_to(unu, _unit(mu))
        umu_pnu = wilsonline._roll_to(umu, _unit(nu))
        fwd = sun.mul(unu_pmu, sun.dagger(sun.mul(unu, umu_pnu)))
        bwd_at = sun.mul(sun.dagger(sun.mul(umu, unu_pmu)), unu)
        bwd = wilsonline._roll_to(bwd_at, _unit(nu, -1))
        total = total + fwd + bwd
    return total


def staples(action: GaugeAction, u: torch.Tensor, mu: int) -> torch.Tensor:
    """Weighted staple sum V_mu(y), d(sum c tr W)/d(U_mu) = V^T."""
    if action.plaq_coeff == 0.0:
        raise NotImplementedError("general gauge actions are not ported yet (ROADMAP A3)")
    return action.plaq_coeff * _plaquette_staple(u, mu)


def force(action: GaugeAction, u: torch.Tensor) -> torch.Tensor:
    """Hdot_mu(y) = (1/NC) proj_TH(i U_mu(y) V_mu(y))."""
    out = []
    for mu in range(DIRS):
        v = staples(action, u, mu)
        out.append(sun.traceless_hermitian(1j * sun.mul(u[mu], v)) / action.nc)
    return torch.stack(out, dim=0)


def plaquette_sum(u: torch.Tensor) -> torch.Tensor:
    """sum_x sum_{mu<nu} Re tr P_munu(x)."""
    total = 0.0
    for mu in range(DIRS):
        for nu in range(mu + 1, DIRS):
            umu = u[mu]
            unu = u[nu]
            a = sun.mul(umu, wilsonline._roll_to(unu, _unit(mu)))
            b = sun.mul(unu, wilsonline._roll_to(umu, _unit(nu)))
            total = total + torch.sum(torch.real(sun.trace(sun.mul(a, sun.dagger(b)))))
    return total


def mean_plaquette(u: torch.Tensor) -> torch.Tensor:
    """<Re tr P> / (6 NV NC) in 4D."""
    nc = u.shape[-1]
    nv = 1
    for n in u.shape[1:5]:
        nv *= n
    comb = DIRS * (DIRS - 1) // 2
    return plaquette_sum(u) / (comb * nv * nc)
