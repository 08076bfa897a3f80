"""Leveled, file-teed logger (a copy of latticeqcd_tpu/utils/logger.py).

Counterpart of Gaugefields.jl's Verbose_print (SURVEY.md 2.4.1;
LatticeQCD.jl src/system/universe.jl:54-56,193-203): verboselevel
1-3, rank-0 gated, teed to a log file. println_verbose_levelN prints
iff verboselevel >= N.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional, TextIO


@dataclass
class VerbosePrint:
    level: int = 2
    myid: int = 0
    filename: Optional[str] = None
    fp: Optional[TextIO] = None
    echo: bool = True

    def __post_init__(self):
        if self.filename is not None and self.fp is None and self.myid == 0:
            self.fp = open(self.filename, "w")

    def _emit(self, *vals):
        if self.myid != 0:
            return
        msg = "".join(str(v) for v in vals)
        if self.echo:
            print(msg)
        if self.fp is not None:
            self.fp.write(msg + "\n")

    def println_verbose_level1(self, *vals):
        if self.level >= 1:
            self._emit(*vals)

    def println_verbose_level2(self, *vals):
        if self.level >= 2:
            self._emit(*vals)

    def println_verbose_level3(self, *vals):
        if self.level >= 3:
            self._emit(*vals)

    def flush(self):
        if self.fp is not None:
            self.fp.flush()
        sys.stdout.flush()

    def close(self):
        if self.fp is not None:
            self.fp.close()
            self.fp = None
