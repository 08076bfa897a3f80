"""Conjugate gradient for the fermion solves.

Counterpart of latticeqcd_tpu/ops/solvers.py ``cg``: stopping criterion
|r|^2 < eps * max(|b|^2, 1), eps clamped per dtype to an attainable
target, and in reduced precision verified-exit restarts gated on the
true residual. The loop reads |r|^2 to the host once per iteration for
its exit test (one device sync per iteration, a known cost). Batched,
multi-shift and BiCGStab solvers wait for later slices (ROADMAP A5).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# Reduced precision: the attainable relative TRUE |r|^2, and how many
# restarts from the true residual may run (the JAX package's numbers).
_N_RESTARTS = {torch.complex64: 2, torch.float32: 2}
_VERIFY_FLOOR = 3e-11


def _vdot(a, b):
    return torch.sum(a.conj() * b)


def _effective_eps(eps: float, dtype) -> float:
    """Clamp the relative |r|^2 target to what the dtype can reach: an
    f64-tuned eps (1e-19) would make every complex64 solve run to maxiter."""
    if dtype in (torch.complex64, torch.float32):
        return max(float(eps), 2.5e-13)
    return float(eps)


def cg(apply_a: Callable, b: torch.Tensor, x0=None, eps: float = 1e-19, maxiter: int = 3000,
       log: Optional[list] = None):
    """CG for hermitian positive definite A; returns (x, iterations, |r|^2).

    In complex64 the exit residual is verified against the true b - A x,
    the recursion restarted from it (up to twice) while that residual
    misses the attainable target and still improves, and the returned
    |r|^2 is the verified true residual; in complex128 it is the
    recursion's. ``log``, if given, receives one dict per solve with the
    iteration count and the returned |r|^2 and its target, both relative
    to max(|b|^2, 1)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_a(x) if x0 is not None else b
    rsq = torch.real(_vdot(r, r))
    bsq = max(float(torch.real(_vdot(b, b))), 1.0)
    target = _effective_eps(eps, b.dtype) * bsq

    def run(x, r, p, rsq, it):
        rsq_h = float(rsq)
        while rsq_h > target and it < maxiter:
            ap = apply_a(p)
            alpha = rsq / torch.real(_vdot(p, ap))
            x = x + alpha * p
            r = r - alpha * ap
            rsq_new = torch.real(_vdot(r, r))
            p = r + (rsq_new / rsq) * p
            rsq = rsq_new
            rsq_h = float(rsq)
            it += 1
        return x, r, p, rsq, it

    x, r, p, rsq, it = run(x, r, r, rsq, 0)
    verify = target
    n_restarts = _N_RESTARTS.get(b.dtype, 0)
    if n_restarts:
        verify = max(target, _VERIFY_FLOOR * bsq)
        prev_true = float("inf")
        for _ in range(n_restarts):
            r_true = b - apply_a(x)
            rsq_true = torch.real(_vdot(r_true, r_true))
            rsq_true_h = float(rsq_true)
            if verify < rsq_true_h < prev_true:
                x, r, p, rsq, it = run(x, r_true, r_true, rsq_true, it)
            prev_true = rsq_true_h
        r_true = b - apply_a(x)
        rsq = torch.real(_vdot(r_true, r_true))
    if log is not None:
        log.append({"iterations": it, "rsq": float(rsq) / bsq, "target": verify / bsq})
    return x, it, rsq
