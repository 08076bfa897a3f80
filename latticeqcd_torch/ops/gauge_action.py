"""Loop-based gauge actions: value, staples, HMC force, plaquette.

Counterpart of latticeqcd_tpu/ops/gauge_action.py with the reference's
conventions: an action is a list of (coupling, loop set) terms, the
Wilson action is the plaquette loops plus their adjoints at coupling
beta/2, and S_g = -Re evaluate(U) / NC. The Wilson action's staples and
forces use the fused 6-staple form; any other action (rectangles,
chairs, Polyakov lines, user loops) takes the generic path derivative
``wilsonline.staple_sum``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from latticeqcd_torch.ops import sun, wilsonline
from latticeqcd_torch.ops.wilsonline import make_loops_fromname
from latticeqcd_torch.parallel.mesh import global_sum, global_volume

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

    def weighted_lines(self):
        return [(c, line) for c, loops in self.terms for line in loops]

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


def general_gauge_action(nc: int, couplings, loopsets) -> GaugeAction:
    """Each loop set with its adjoints at coupling c/2."""
    act = GaugeAction(nc)
    for c, loops in zip(couplings, loopsets):
        act = act.push(c / 2, list(loops) + [l.adjoint() for l in loops])
    return act


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
    """Weighted staple sum V_mu(y), d(sum c tr W)/d(U_mu) = V^T: the fused
    6-staple form for the Wilson action, the generic path derivative else."""
    if action.plaq_coeff != 0.0:
        return action.plaq_coeff * _plaquette_staple(u, mu)
    return wilsonline.staple_sum(u, action.weighted_lines(), mu)


def local_heatbath_exponent_matrix(action: GaugeAction, u: torch.Tensor, mu: int) -> torch.Tensor:
    """V with the single-link weight exp(+(2/NC) Re tr(U_mu(y) V(y)))."""
    return staples(action, u, mu)


def force(action: GaugeAction, u: torch.Tensor) -> torch.Tensor:
    """Hdot_mu(y) = (1/NC) proj_TH(i U_mu(y) V_mu(y))."""
    out = []
    for mu in range(DIRS):
        v = staples(action, u, mu)
        out.append(sun.traceless_hermitian(1j * sun.mul(u[mu], v)) / action.nc)
    return torch.stack(out, dim=0)


def force_autodiff(action: GaugeAction, u: torch.Tensor) -> torch.Tensor:
    """The force from torch.autograd of S_g, for any action (a test oracle).

    The JAX package's rule is Hdot = -(1/2) proj_TH(i U g^T) for JAX's
    gradient g; PyTorch's gradient is its complex conjugate, so
    g^T = grad^dag here."""
    uu = u.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(action_value(action, uu), uu)
    out = []
    for mu in range(DIRS):
        m = 1j * sun.mul(u[mu], sun.dagger(g[mu]))
        out.append(-0.5 * sun.traceless_hermitian(m))
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
    return global_sum(total)


def mean_plaquette(u: torch.Tensor) -> torch.Tensor:
    """<Re tr P> / (6 NV NC) in 4D."""
    nc = u.shape[-1]
    nv = global_volume(u.shape[1:5])
    comb = DIRS * (DIRS - 1) // 2
    return plaquette_sum(u) / (comb * nv * nc)
