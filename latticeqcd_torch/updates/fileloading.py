"""Load-and-measure updater: each "update" loads the next stored configuration.

Counterpart of latticeqcd_tpu/updates/fileloading.py (LatticeQCD.jl's
GivenConfigurations): scan loadU_dir for the files of loadU_format, or
read their names from a list file (loadU_fromfile, loadU_filename; one
name per line, ``#`` comments), and expand a multi-config ILDG file into
one entry per configuration. A run takes one step per entry.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List

from latticeqcd_torch.io import ILDG, load_config

_EXT = {"JLD": (".jld2", ".npz"), "NPZ": (".npz",), "ILDG": (".ildg",), "BridgeText": (".txt",)}


@dataclass
class GivenConfigurations:
    loadU_format: str
    loadU_dir: str
    lattice: tuple
    nc: int
    filelist: List = field(default_factory=list)
    current: int = 0
    _ildg_handles: dict = field(default_factory=dict, repr=False)

    def _ildg(self, fn):
        """One header scan per file, reused across updates."""
        h = self._ildg_handles.get(fn)
        if h is None:
            h = self._ildg_handles[fn] = ILDG(fn)
        return h

    @classmethod
    def from_params(cls, p, lattice, nc):
        fmt = p.loadU_format
        if fmt not in _EXT:
            raise ValueError(f"loadU_format should be JLD/NPZ, ILDG or BridgeText, got {fmt!r}")
        if p.loadU_fromfile:
            with open(os.path.join(p.loadU_dir, p.loadU_filename)) as fp:
                names = [l.split()[0] for l in fp if l.strip() and not l.startswith("#")]
            files = [os.path.join(p.loadU_dir, n) for n in names]
        else:
            files = sorted(
                os.path.join(p.loadU_dir, f)
                for f in os.listdir(p.loadU_dir)
                if f.endswith(_EXT[fmt])
            )
        if not files:
            raise FileNotFoundError(f"no {fmt} configurations in {p.loadU_dir!r}")
        self = cls(fmt, p.loadU_dir, tuple(lattice), nc)
        if fmt == "ILDG":
            # expand multi-config LIME files into one entry per record,
            # keeping the scanned handles for the load phase
            expanded = []
            for f in files:
                n = len(self._ildg(f))
                expanded.extend([(f, i + 1) for i in range(n)] if n > 1 else [f])
            files = expanded
        self.filelist = files
        return self

    @property
    def Nsteps(self) -> int:
        """One step per stored configuration."""
        return len(self.filelist)

    def _load(self, entry, dtype, device):
        if isinstance(entry, tuple):  # (file, 1-based index) in a multi-config ILDG file
            fn, idx = entry
            return self._ildg(fn).load(idx, self.lattice, self.nc, dtype=dtype, device=device)
        return load_config(self.loadU_format, entry, self.lattice, self.nc, dtype, device)

    def step(self, u, generator=None):
        """(U, generator) -> (the next configuration, in U's dtype and on its
        device; stats), as HMC.step. Always accepted; draws nothing."""
        fn = self.filelist[self.current]
        self.current += 1
        return self._load(fn, u.dtype, u.device), {"accepted": True}
