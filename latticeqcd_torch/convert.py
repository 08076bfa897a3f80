"""Carry state between the JAX package and the port.

Links [4, X, Y, Z, T, NC, NC], spinors [X, Y, Z, T, 4, NC] and momenta
have the same layout in both packages, so a numpy array of one becomes
a tensor of the other as it is. The action parameters (beta, kappa, r,
bc, csw) travel in ``system.params.Params``.
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(a, device="cuda", dtype=None) -> torch.Tensor:
    """numpy (or array-like) -> tensor on ``device`` (the card unless the
    caller asks for the CPU, like every entry point of the port), cast to
    ``dtype`` if given."""
    return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor (any device) -> numpy array on the host."""
    return t.detach().cpu().resolve_conj().resolve_neg().numpy()
