"""Measurement scheduling and text output.

Counterpart of latticeqcd_tpu/measurements/scheduler.py with the same
file names (<measuredir>/<methodname><suffix>.txt, the suffix "_flow" for
the flowed series) and line formats, for the gauge observables
Plaquette, Polyakov_loop, Topological_charge, Energy_density and
Wilson_loop and the fermionic methods Chiral_condensate, Pion_correlator
and Dirac_spectrum (Wilson with or without the clover term, staggered and
domain-wall operators, built from the method's ``fermion_parameters``).
Every ``measure`` takes the JAX package's ``additional_string``, which the
flow writes after itrj.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from latticeqcd_torch.measurements import fermionic, observables
from latticeqcd_torch.ops.dirac.domainwall import DomainwallDirac
from latticeqcd_torch.ops.dirac.staggered import StaggeredDirac
from latticeqcd_torch.ops.dirac.wilson import WilsonDirac
from latticeqcd_torch.parallel import mesh


def build_dirac_from_params(params: Dict[str, Any], lattice, default_bc=(1, 1, 1, -1)):
    """fermion_parameters dict -> Dirac operator, with the JAX package's keys
    and defaults (Wilson and WilsonClover: hop or kappa 0.141139, r 1, and for
    WilsonClover Clover_coefficient 0.0; staggered: mass 0.5; domain wall:
    Domainwall_m or mass 1.0, Domainwall_M or M -1.0, Domainwall_L5 or L5 4;
    boundarycondition (1, 1, 1, -1))."""
    kind = params.get("Dirac_operator", "Wilson")
    bc = tuple(params.get("boundarycondition", default_bc))
    if kind in ("Wilson", "WilsonClover"):
        r = float(params.get("r", 1.0))
        csw = float(params.get("Clover_coefficient", 0.0)) if kind == "WilsonClover" else 0.0
        return WilsonDirac(kappa=float(params.get("hop", params.get("kappa", 0.141139))),
                           r=r, bc=bc, csw=csw)
    if kind in ("Staggered", "staggered"):
        return StaggeredDirac(mass=float(params.get("mass", 0.5)), lattice=tuple(lattice), bc=bc)
    if kind in ("Domainwall", "domainwall"):
        return DomainwallDirac(
            mass=float(params.get("Domainwall_m", params.get("mass", 1.0))),
            m5=float(params.get("Domainwall_M", params.get("M", -1.0))),
            l5=int(params.get("Domainwall_L5", params.get("L5", 4))),
            bc=bc,
        )
    raise ValueError(f"unknown Dirac_operator {kind!r}")


@dataclass
class Measurement:
    name: str
    interval: int
    params: Dict[str, Any] = field(default_factory=dict)
    fp: Optional[Any] = None

    def measure(self, u, itrj, additional_string="") -> str:
        raise NotImplementedError

    def emit(self, line: str):
        if self.fp is not None:
            self.fp.write(line + "\n")
            self.fp.flush()
        return line


class PlaquetteMeasurement(Measurement):
    """format: "$itrj $additional$plaq # plaq"."""

    def measure(self, u, itrj, additional_string=""):
        plaq = float(observables.mean_plaquette(u))
        return self.emit(f"{itrj} {additional_string}{plaq} # plaq")


class PolyakovMeasurement(Measurement):
    """format: "$itrj $additional$re $im # poly"."""

    def measure(self, u, itrj, additional_string=""):
        p = complex(observables.polyakov_loop(u))
        return self.emit(f"{itrj} {additional_string}{p.real} {p.imag} # poly")


class TopologicalChargeMeasurement(Measurement):
    """kinds_of_topological_charge (default plaquette and clover; clover also
    writes the improved Q). Format: "$itrj $additional$Q... # itrj Qplaq
    Qclover Qimproved", the header naming the kinds measured. ``value``
    holds the charges."""

    value: Any = None

    def measure(self, u, itrj, additional_string=""):
        kinds = self.params.get("kinds_of_topological_charge", ["plaquette", "clover"])
        values: List[float] = []
        header: List[str] = []
        for kind in kinds:
            if kind == "plaquette":
                values.append(float(observables.topological_charge(u, "plaquette")))
                header.append("Qplaq")
            elif kind == "clover":
                values.extend([float(observables.topological_charge(u, "clover")),
                               float(observables.topological_charge(u, "improved"))])
                header.extend(["Qclover", "Qimproved"])
            else:
                raise ValueError(f"topological charge kind {kind!r}")
        self.value = values
        return self.emit(f"{itrj} {additional_string}" + " ".join(str(v) for v in values)
                         + " # itrj " + " ".join(header))


class EnergyDensityMeasurement(Measurement):
    """format: "$itrj $additional$E # energydensity"."""

    value: Any = None

    def measure(self, u, itrj, additional_string=""):
        self.value = float(observables.energy_density(u))
        return self.emit(f"{itrj} {additional_string}{self.value} # energydensity")


class WilsonLoopMeasurement(Measurement):
    """W(R, T) for R = 1..Rmax, T = 1..Tmax (default 4 and 4), one line each:
    "$itrj $additional$R $T $W # RxT wilson loop". ``value`` holds W as an
    Rmax x Tmax array."""

    value: Any = None

    def measure(self, u, itrj, additional_string=""):
        rmax = int(self.params.get("Rmax", 4))
        tmax = int(self.params.get("Tmax", 4))
        vals = np.zeros((rmax, tmax))
        lines = []
        for r in range(1, rmax + 1):
            for t in range(1, tmax + 1):
                w = float(observables.wilson_loop_rt(u, r, t))
                vals[r - 1, t - 1] = w
                lines.append(self.emit(f"{itrj} {additional_string}{r} {t} {w} # RxT wilson loop"))
        self.value = vals
        return "\n".join(lines)


class FermionicMeasurement(Measurement):
    """A method that solves with the operator of its ``fermion_parameters``.
    After each call ``value`` holds the measured numbers and ``solves`` the
    solver records of that call."""

    default_operator = "Wilson"
    value: Any = None
    solves: Optional[list] = None

    def _dirac(self, u):
        """(fermion_parameters, the operator on the fields of u's lattice: the block's
        under a process grid)."""
        fparams = self.params.get("fermion_parameters", {"Dirac_operator": self.default_operator})
        return fparams, build_dirac_from_params(fparams, u.shape[1:5])

    def _solver_args(self):
        self.solves = []
        return dict(eps=float(self.params.get("eps", 1e-19)),
                    maxiter=int(self.params.get("MaxCGstep", 3000)), log=self.solves)


class ChiralCondensateMeasurement(FermionicMeasurement):
    """Stochastic pbp, factor Nf/4 for staggered. Format: one
    "# $itrj $irand $value # itrj irand chiralcond" line per noise vector,
    then "$itrj $pbp # pbp Nr=$Nr" (the additional string in the first
    only). Noise from a Generator seeded with noise_seed + itrj."""

    default_operator = "Staggered"

    def measure(self, u, itrj, additional_string=""):
        fparams, dirac = self._dirac(u)
        nr = int(self.params.get("Nr", 10))
        factor = float(fparams.get("Nf", 4)) / 4.0 if isinstance(dirac, StaggeredDirac) else 1.0
        gen = torch.Generator(device=u.device).manual_seed(
            int(self.params.get("noise_seed", 4513)) + itrj)
        pbp, vals = fermionic.chiral_condensate(u, dirac, gen, nr=nr, nf_factor=factor,
                                                **self._solver_args())
        self.value = (pbp, vals)
        lines = [self.emit(f"# {itrj} {ir} {additional_string}{v} # itrj irand chiralcond")
                 for ir, v in enumerate(vals, start=1)]
        lines.append(self.emit(f"{itrj} {pbp} # pbp Nr={nr}"))
        return "\n".join(lines)


class PionCorrelatorMeasurement(FermionicMeasurement):
    """Point-source pion correlator. Format: "$itrj $C(0) ... $C(T-1) "
    then "#pioncorrelator" (no additional string, as in the JAX package)."""

    def measure(self, u, itrj, additional_string=""):
        _, dirac = self._dirac(u)
        cpi = fermionic.pion_correlator(u, dirac, **self._solver_args())
        self.value = cpi
        s = self.emit(f"{itrj} " + " ".join(str(float(c)) for c in cpi) + " ")
        self.emit("#pioncorrelator")
        return s


class DiracSpectrumMeasurement(FermionicMeasurement):
    """Neig lowest eigenvalues of the measurement operator (packed
    staggered W, or D^dag D) from Nlanczos Lanczos steps. Format:
    "$itrj $additional$lam1 ... $lamk # dirac low spectrum"."""

    default_operator = "Staggered"

    def measure(self, u, itrj, additional_string=""):
        _, dirac = self._dirac(u)
        m = self.params.get("Nlanczos")
        self.solves = []
        vals = fermionic.dirac_low_spectrum(u, dirac, k=int(self.params.get("Neig", 8)),
                                            m=int(m) if m is not None else None)
        self.value = vals
        return self.emit(f"{itrj} {additional_string}" + " ".join(f"{v:.10g}" for v in vals)
                         + " # dirac low spectrum")


_REGISTRY = {
    "Plaquette": PlaquetteMeasurement,
    "Polyakov_loop": PolyakovMeasurement,
    "Topological_charge": TopologicalChargeMeasurement,
    "Energy_density": EnergyDensityMeasurement,
    "Wilson_loop": WilsonLoopMeasurement,
    "Chiral_condensate": ChiralCondensateMeasurement,
    "Pion_correlator": PionCorrelatorMeasurement,
    "Dirac_spectrum": DiracSpectrumMeasurement,
}


@dataclass
class MeasurementSet:
    measurements: List[Measurement] = field(default_factory=list)

    @classmethod
    def from_methods(cls, method_dicts, measuredir: Optional[str] = None, suffix: str = "",
                     append: bool = False):
        """One measurement per method dict, each writing
        <measuredir>/<methodname><suffix>.txt (appending to it if ``append``, as
        a resumed run does); under a process grid only rank 0 writes."""
        ms = []
        for method in method_dicts or []:
            name = method.get("methodname")
            if name not in _REGISTRY:
                raise ValueError(f"measurement method {name!r} is not supported")
            fp = None
            if measuredir is not None and mesh.is_rank0():
                os.makedirs(measuredir, exist_ok=True)
                fp = open(os.path.join(measuredir, f"{name}{suffix}.txt"), "a" if append else "w")
            interval = int(method.get("measure_every", 1))
            ms.append(_REGISTRY[name](name=name, interval=interval, params=dict(method), fp=fp))
        return cls(measurements=ms)

    def calc_measurement_values(self, itrj, u, additional_string="", step=None):
        """Run every method due at ``step`` (the flow step of a flowed
        measurement; itrj if None); returns the emitted lines."""
        step = itrj if step is None else step
        return [m.measure(u, itrj, additional_string) for m in self.measurements
                if m.interval > 0 and step % m.interval == 0]

    def close(self):
        for m in self.measurements:
            if m.fp is not None:
                m.fp.close()
                m.fp = None
