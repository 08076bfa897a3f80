"""Measurement scheduling and text output: Plaquette and Polyakov_loop.

Counterpart of latticeqcd_tpu/measurements/scheduler.py with the same
file names (<measuredir>/<methodname>.txt) and line formats. The other
methods (topological charge, energy density, Wilson loops, fermionic
measurements) wait for later slices (ROADMAP A11).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, List, Optional

from latticeqcd_torch.measurements import observables


@dataclass
class Measurement:
    name: str
    interval: int
    fp: Optional[Any] = None

    def measure(self, u, itrj) -> str:
        raise NotImplementedError

    def emit(self, line: str):
        if self.fp is not None:
            self.fp.write(line + "\n")
            self.fp.flush()
        return line


class PlaquetteMeasurement(Measurement):
    """format: "$itrj $plaq # plaq"."""

    def measure(self, u, itrj):
        return self.emit(f"{itrj} {float(observables.mean_plaquette(u))} # plaq")


class PolyakovMeasurement(Measurement):
    """format: "$itrj $re $im # poly"."""

    def measure(self, u, itrj):
        p = complex(observables.polyakov_loop(u))
        return self.emit(f"{itrj} {p.real} {p.imag} # poly")


_REGISTRY = {"Plaquette": PlaquetteMeasurement, "Polyakov_loop": PolyakovMeasurement}


@dataclass
class MeasurementSet:
    measurements: List[Measurement] = field(default_factory=list)

    @classmethod
    def from_methods(cls, method_dicts, measuredir: Optional[str] = None):
        ms = []
        for method in method_dicts or []:
            name = method.get("methodname")
            if name not in _REGISTRY:
                raise NotImplementedError(
                    f"measurement method {name!r} is not ported yet (ROADMAP A11)")
            fp = None
            if measuredir is not None:
                os.makedirs(measuredir, exist_ok=True)
                fp = open(os.path.join(measuredir, f"{name}.txt"), "w")
            interval = int(method.get("measure_every", 1))
            ms.append(_REGISTRY[name](name=name, interval=interval, fp=fp))
        return cls(measurements=ms)

    def calc_measurement_values(self, itrj, u):
        """Run every method due at itrj; returns the emitted lines."""
        return [m.measure(u, itrj) for m in self.measurements
                if m.interval > 0 and itrj % m.interval == 0]

    def close(self):
        for m in self.measurements:
            if m.fp is not None:
                m.fp.close()
                m.fp = None
