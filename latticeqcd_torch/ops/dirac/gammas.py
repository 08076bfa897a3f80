"""Euclidean gamma matrices (hermitian, {g_mu, g_nu} = 2 delta).

The same DeGrand-Rossi chiral basis as latticeqcd_tpu/ops/dirac/gammas.py,
gamma5 = g1 g2 g3 g4 = diag(1, 1, -1, -1). Kept as a numpy-only copy
because importing the JAX package's module imports its ops package, and
with it jax; the tests check the two copies are equal.
"""

import numpy as np

_i = 1j

GAMMA = np.zeros((4, 4, 4), dtype=np.complex128)
GAMMA[0] = [[0, 0, 0, _i], [0, 0, _i, 0], [0, -_i, 0, 0], [-_i, 0, 0, 0]]  # x
GAMMA[1] = [[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]]  # y
GAMMA[2] = [[0, 0, _i, 0], [0, 0, 0, -_i], [-_i, 0, 0, 0], [0, _i, 0, 0]]  # z
GAMMA[3] = [[0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0]]  # t

GAMMA5 = np.diag([1.0, 1.0, -1.0, -1.0]).astype(np.complex128)

ID4 = np.eye(4, dtype=np.complex128)


def projectors(r: float = 1.0):
    """Hopping projectors P^-_mu = (r - gamma_mu), P^+_mu = (r + gamma_mu)."""
    pm = np.stack([r * ID4 - GAMMA[mu] for mu in range(4)])
    pp = np.stack([r * ID4 + GAMMA[mu] for mu in range(4)])
    return pm, pp


def _half_factor(p):
    """V (4x2) with p = 2 V V^dag for a rank-2 projector-like 2*P."""
    w, v = np.linalg.eigh(p)
    idx = np.argsort(w)[::-1][:2]
    assert np.allclose(sorted(w), [0, 0, 2, 2]), w
    return v[:, idx] * np.sqrt(w[idx] / 2.0)[None, :]


def half_spinor_factors():
    """(Vm[4,4,2], Vp[4,4,2]) with (1 -+ gamma_mu) = 2 V V^dag at r=1."""
    pm, pp = projectors(1.0)
    vm = np.stack([_half_factor(pm[mu]) for mu in range(4)])
    vp = np.stack([_half_factor(pp[mu]) for mu in range(4)])
    return vm, vp
