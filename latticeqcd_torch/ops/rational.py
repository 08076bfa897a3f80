"""Rational approximations of x^(+-beta) in partial-fraction form.

A copy of latticeqcd_tpu/ops/rational.py (numpy and scipy only; the port
imports nothing of the JAX package), pinned to the original's
coefficients by tests/test_torch_import.py. The coefficients come from
the Gauss-Jacobi discretization of the exact integral representation

    x^-b = sin(pi b)/pi * int_0^inf t^-b / (t + x) dt,  0 < b < 1,

with the Moebius substitution t = c (1+v)/(1-v), which turns the
integrand into a Jacobi weight (1-v)^(b-1) (1+v)^(-b); N-point
Gauss-Jacobi then yields r(x) = sum_j a_j/(x + b_j) with positive
residues/shifts and geometric convergence in N. Exponents outside
(0,1) are reduced with exact identities (x^b = x * x^(b-1);
x^-b = x^-(b-1) * x^-1 re-expanded over shifts including 0). N is
chosen adaptively against a dense log-grid max-relative-error check on
the host, and the results are cached; no approximation within the
tolerance is an error, never a silently worse one.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
from scipy.special import roots_jacobi


@dataclass(frozen=True)
class PartialFraction:
    """r(x) = const + sum_j residues[j] / (x + shifts[j])."""

    const: float
    residues: tuple
    shifts: tuple
    lo: float
    hi: float
    max_rel_err: float

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float64)
        out = np.full_like(x, self.const)
        for a, b in zip(self.residues, self.shifts):
            out = out + a / (x + b)
        return out

    @property
    def nterms(self):
        return len(self.residues)


def _gauss_jacobi_pf(beta: float, n: int, c: float) -> tuple:
    """Partial fractions for x^-beta, 0<beta<1, from N-point Gauss-Jacobi."""
    # scipy's recurrence emits a benign "invalid value in divide" for
    # a+b = -1 (the k==1 branch of its np.where); values are correct.
    with np.errstate(invalid="ignore"):
        v, w = roots_jacobi(n, beta - 1.0, -beta)
    pref = np.sin(np.pi * beta) / np.pi * 2.0 * c ** (1.0 - beta)
    residues = pref * w / (1.0 - v)
    shifts = c * (1.0 + v) / (1.0 - v)
    return residues, shifts


def _max_rel_err(pf_eval, beta: float, lo: float, hi: float) -> float:
    x = np.geomspace(lo, hi, 4001)
    exact = x ** (-beta)
    return float(np.max(np.abs(pf_eval(x) - exact) / np.abs(exact)))


@lru_cache(maxsize=None)
def rational_inverse_power(
    beta: float, lo: float, hi: float, tol: float = 1e-10, max_terms: int = 80
) -> PartialFraction:
    """x^-beta on [lo, hi] for 0 < beta < 2 as partial fractions."""
    if not (0.0 < beta < 2.0):
        raise ValueError(f"beta must be in (0,2), got {beta}")
    if abs(beta - 1.0) < 1e-14:
        return PartialFraction(0.0, (1.0,), (0.0,), lo, hi, 0.0)
    c = float(np.sqrt(lo * hi))
    if beta < 1.0:
        for n in range(6, max_terms + 1, 2):
            residues, shifts = _gauss_jacobi_pf(beta, n, c)

            def ev(x, residues=residues, shifts=shifts):
                return np.sum(residues[:, None] / (x[None, :] + shifts[:, None]), axis=0)

            err = _max_rel_err(ev, beta, lo, hi)
            if err < tol:
                return PartialFraction(0.0, tuple(residues), tuple(shifts), lo, hi, err)
        raise RuntimeError(f"no {tol} approx of x^-{beta} on [{lo},{hi}] with {max_terms} terms")
    # 1 < beta < 2: x^-beta = x^-(beta-1) * x^-1, re-expanded:
    #   sum c_j/(x(x+d_j)) = (sum c_j/d_j)/x - sum (c_j/d_j)/(x+d_j)
    inner = rational_inverse_power(beta - 1.0, lo, hi, tol=tol * 0.1, max_terms=max_terms)
    cj = np.asarray(inner.residues)
    dj = np.asarray(inner.shifts)
    res0 = float(np.sum(cj / dj))
    residues = tuple([res0] + list(-cj / dj))
    shifts = tuple([0.0] + list(dj))
    pf = PartialFraction(0.0, residues, shifts, lo, hi, 0.0)
    err = _max_rel_err(pf, beta, lo, hi)
    if err >= tol:
        # cancellation in the re-expansion can eat the inner tolerance;
        # fail loudly like the beta<1 branch rather than returning an
        # approximation with an unbounded systematic error
        raise RuntimeError(
            f"no {tol} approx of x^-{beta} on [{lo},{hi}]: re-expansion "
            f"reached {err:.2e} with {len(residues)} terms"
        )
    return PartialFraction(0.0, residues, shifts, lo, hi, err)


@lru_cache(maxsize=None)
def rational_power(
    beta: float, lo: float, hi: float, tol: float = 1e-10, max_terms: int = 80
) -> PartialFraction:
    """x^+beta on [lo, hi] for 0 < beta <= 1 as const + partial fractions.

    x^b = x * x^-(1-b) = sum a_j x/(x+b_j) = sum a_j - sum a_j b_j/(x+b_j).
    """
    if not (0.0 < beta <= 1.0):
        raise ValueError(f"beta must be in (0,1], got {beta}")
    if abs(beta - 1.0) < 1e-14:
        # exact: r(x) = x — callers special-case const_x
        return PartialFraction(0.0, (), (), lo, hi, 0.0)
    inv = rational_inverse_power(1.0 - beta, lo, hi, tol=tol, max_terms=max_terms)
    aj = np.asarray(inv.residues)
    bj = np.asarray(inv.shifts)
    const = float(np.sum(aj))
    residues = tuple(-aj * bj)
    shifts = tuple(bj)
    pf = PartialFraction(const, residues, shifts, lo, hi, 0.0)
    x = np.geomspace(lo, hi, 4001)
    err = float(np.max(np.abs(pf(x) - x**beta) / x**beta))
    if err >= tol:
        raise RuntimeError(
            f"no {tol} approx of x^{beta} on [{lo},{hi}]: transformation "
            f"reached {err:.2e} with {len(residues)} terms"
        )
    return PartialFraction(const, residues, shifts, lo, hi, err)
