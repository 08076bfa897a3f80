"""Mixed-precision MD state (HMC md_precision = "mixed").

Counterpart of latticeqcd_tpu/ops/mdpair.py. In complex64 the
integrator's own arithmetic (the exp(i eps H) U products and the kick
accumulation H += eps F) rounds enough to bias dH: the JAX package
measured a +0.078 +- 0.026 dH offset and about 18 points less acceptance
at 8^4 and traced it to that rounding. The fix runs only the MD state
(U, H) and its updates in double precision, while every force, solve and
action value, and the links handed to the next trajectory, stay in the
production dtype.

Why there is no pair class here: the JAX package stores the state as
float64 (re, im) pairs only because its TPU cannot compile complex128.
The H100 computes complex128 natively, so the state is a complex128
tensor and every operation of the pair module is an existing one:

- the lift is ``lift`` below (exact);
- the view every force and action is evaluated on is ``x.to(dtype)``,
  which rounds each part to nearest, as mdpair.lower's float64 -> float32
  casts do (and is a no-op when x already has that dtype);
- the compensated kick of PairField.__add__ is PyTorch's type promotion:
  a complex64 increment eps * F added to a complex128 H is widened exactly
  and summed in double, so md/integrators.py's schemes run unchanged on
  the lifted state;
- the exponential and the link update are sun.expi_hermitian and
  integrators.update_links in complex128: the Cayley-Hamilton closed form
  for NC = 3 (the pair module's choice), the SU(2) closed form for NC = 2
  and Taylor with scaling and squaring otherwise (the pair module takes
  Taylor with scaling and squaring for every NC other than 3; the two
  agree to about 1e-15 in double);
- the kinetic energy is sun.kinetic_energy on the lifted H: tr H^2 in
  complex128, a float64 value equal to the pair's sum of |H_ij|^2 up to
  rounding, since H is hermitian.
"""

from __future__ import annotations

import torch

MD_DTYPE = torch.complex128


def lift(x: torch.Tensor) -> torch.Tensor:
    """Production-dtype field -> the complex128 MD state (exact)."""
    return x.to(MD_DTYPE)
