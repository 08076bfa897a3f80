"""Gauge-configuration files: NPZ (native), ILDG, Bridge++ text and JLD2.

Counterpart of latticeqcd_tpu/io with the same names. The modules are
copies, not imports: the JAX package's io imports jax.
"""

import torch

from latticeqcd_torch.io.bridge_text import load_bridge_text, save_bridge_text  # noqa: F401
from latticeqcd_torch.io.ildg import ILDG, load_ildg, save_ildg  # noqa: F401
from latticeqcd_torch.io.jld2 import load_jld2, save_jld2  # noqa: F401
from latticeqcd_torch.io.native import (load_checkpoint, load_u, save_checkpoint,  # noqa: F401
                                        save_u)


def load_config(fmt, filename, lattice, nc: int, dtype=torch.complex128,
                device="cuda") -> torch.Tensor:
    """Load the links in ``filename`` by loadU_format ``fmt`` (ILDG, BridgeText,
    or JLD/NPZ, which take a .jld2/.jld or an .npz file alike), with the JAX
    package's errors for a missing or unknown format (universe.py:50-67)."""
    kw = dict(dtype=dtype, device=device)
    if fmt == "ILDG":
        return load_ildg(filename, lattice, nc, **kw)
    if fmt == "BridgeText":
        return load_bridge_text(filename, lattice, nc, **kw)
    if fmt in ("JLD", "NPZ"):
        if str(filename).endswith((".jld2", ".jld")):
            return load_jld2(filename, lattice, nc, **kw)
        return load_u(filename, **kw)
    if fmt is None:
        raise ValueError(
            "loadU_format is not specified. loadU_format should be ILDG, "
            "BridgeText or JLD/NPZ"
        )
    raise ValueError(f"loadU_format should be ILDG, BridgeText or JLD/NPZ, got {fmt!r}")
