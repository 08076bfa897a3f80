"""Updater factory: update_method -> HMC | Heatbath | Fileloading.

Counterpart of latticeqcd_tpu/updates/factory.py for the ported
updaters. SLHMC, SLMC and the integrated updaters raise
NotImplementedError naming ROADMAP A12.
"""

from __future__ import annotations

from latticeqcd_torch.updates.fileloading import GivenConfigurations
from latticeqcd_torch.updates.heatbath import Heatbath
from latticeqcd_torch.updates.hmc import HMC


def _md_scheme(p) -> str:
    """The QPQ bool, or the explicit MDscheme ("QPQ" | "PQP" | "Omelyan")."""
    if p.MDscheme:
        if p.MDscheme not in ("QPQ", "PQP", "Omelyan"):
            raise ValueError(f"MDscheme must be 'QPQ', 'PQP' or 'Omelyan', got {p.MDscheme!r}")
        return p.MDscheme
    return "QPQ" if p.QPQ else "PQP"


def updatemethod(p, univ):
    method = p.update_method
    if method == "HMC":
        return HMC(
            action=univ.gauge_action,
            dtau=p.dtau,
            md_steps=p.MDsteps,
            scheme=_md_scheme(p),
            sexton_weingarten=p.SextonWeingargten,
            nsw=p.N_SextonWeingargten,
            omelyan_lambda=p.omelyan_lambda,
            fermi_action=univ.fermi_action,
            smearing=univ.cov_neural_net,
            md_precision=p.MDprecision,
        )
    if method == "Heatbath":
        if not p.quench:
            raise ValueError("Heatbath update is only for quench case!")
        return Heatbath(action=univ.gauge_action, iteration_max=p.ITERATION_MAX,
                        use_or=p.useOR, num_or=p.numOR)
    if method == "Fileloading":
        return GivenConfigurations.from_params(p, p.L, p.NC)
    raise NotImplementedError(f"update_method = {method!r} is not ported yet (ROADMAP A12)")
