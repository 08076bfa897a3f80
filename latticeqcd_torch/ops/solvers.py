"""Krylov solvers for the fermion solves: CG, batched CG and multi-shift CG.

Counterpart of latticeqcd_tpu/ops/solvers.py ``cg``, ``cg_multi``,
``cg_multi_auto`` and ``multishift_cg``: stopping criterion
|r|^2 < eps * max(|b|^2, 1), eps clamped per dtype to an attainable
target, and for ``cg`` and ``cg_multi`` in reduced precision
verified-exit restarts gated on the true residual (per right-hand side
in ``cg_multi``). Each loop reads its exit test to the host once per
iteration (one device sync per iteration, for the whole batch in
``cg_multi``). BiCGStab waits for a later slice (ROADMAP A5).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
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


def _safe_div(a, b):
    """a / b with 0 where b == 0 (a vanishing denominator means the residual
    is already 0, so a zero step is the right continuation, not NaN)."""
    zero = b == 0
    return torch.where(zero, torch.zeros_like(a), a / torch.where(zero, torch.ones_like(b), b))


def cg_multi(apply_a: Callable, b: torch.Tensor, eps: float = 1e-19, maxiter: int = 3000,
             x0=None, log: Optional[list] = None):
    """Batched CG: solve A x_i = b_i for a stack of right-hand sides at once.

    b has a leading RHS axis (n, ...) and ``apply_a`` maps the whole stack.
    Each RHS carries its own alpha and beta (masked multi-RHS CG, not block
    CG: no Krylov space is shared, so each system converges as it would
    alone, up to rounding); a system whose |r|^2 has met its target is
    frozen (alpha = beta = 0) while the slowest finish. In complex64 the
    exit is verified against the true residual and the recursion restarted
    from it, up to twice, for the systems whose true residual misses the
    attainable target and still improves; the returned per-RHS |r|^2 is
    then the verified one. One host read per iteration tests the whole
    batch. Returns (x, iterations, per-RHS |r|^2); ``log``, if given,
    receives one dict per solve as ``cg``'s does, with the worst RHS's
    relative |r|^2 and the number of right-hand sides."""
    axes = tuple(range(1, b.ndim))

    def rdot(u, v):
        return torch.real(torch.sum(u.conj() * v, dim=axes))

    def bcast(c):
        return c.reshape((-1,) + (1,) * (b.ndim - 1)).to(b.dtype)

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_a(x) if x0 is not None else b
    rsq = rdot(r, r)
    bsq = torch.clamp(rdot(b, b), min=1.0)
    target = _effective_eps(eps, b.dtype) * bsq

    def run(x, r, p, rsq, it):
        while it < maxiter and bool(torch.any(rsq > target)):
            ap = apply_a(p)
            active = rsq > target
            alpha = torch.where(active, _safe_div(rsq, rdot(p, ap)), torch.zeros_like(rsq))
            x = x + bcast(alpha) * p
            r = r - bcast(alpha) * ap
            rsq_new = rdot(r, r)
            # frozen systems keep p = r (bounded), alpha stays 0
            beta = torch.where(active, _safe_div(rsq_new, rsq), torch.zeros_like(rsq))
            p = r + bcast(beta) * p
            rsq = rsq_new
            it += 1
        return x, r, p, rsq, it

    x, r, p, rsq, it = run(x, r, r, rsq, 0)
    verify = target
    n_restarts = _N_RESTARTS.get(b.dtype, 0)
    if n_restarts:
        verify = torch.maximum(target, _VERIFY_FLOOR * bsq)
        prev_true = torch.full_like(rsq, float("inf"))
        for _ in range(n_restarts):
            r_true = b - apply_a(x)
            rsq_true = rdot(r_true, r_true)
            # restart only the systems above the attainable target that still improve;
            # the others enter with |r|^2 = 0 and stay frozen
            go = (rsq_true > verify) & (rsq_true < prev_true)
            x, r, p, rsq, it = run(x, r_true, r_true,
                                   torch.where(go, rsq_true, torch.zeros_like(rsq_true)), it)
            prev_true = rsq_true
        r_true = b - apply_a(x)
        rsq = rdot(r_true, r_true)
    if log is not None:
        log.append({"iterations": it, "rsq": float(torch.max(rsq / bsq)),
                    "target": float(torch.max(verify / bsq)), "rhs": int(b.shape[0])})
    return x, it, rsq


def cg_multi_auto(apply_one: Callable, b: torch.Tensor, eps: float = 1e-19, maxiter: int = 3000,
                  force_mode: Optional[str] = None, x0=None, log: Optional[list] = None):
    """Multi-RHS solve of the single-RHS operator ``apply_one`` over the
    leading axis of b, dispatched on the tensor's device: on the CPU one
    ``cg`` per right-hand side in turn (the JAX package measured that
    faster there), on a CUDA device one ``cg_multi`` over the stack, whose
    apply runs ``apply_one`` on each RHS in turn (a kernel with a leading
    RHS axis, reading the links once per batch, is later work) and whose
    exit test is one host read per iteration for the batch. The semantics
    are the same either way. ``force_mode`` ("batched" or "sequential")
    overrides the dispatch, for the tests. Returns (x, iterations,
    per-RHS |r|^2), iterations the largest over the right-hand sides on the
    sequential path."""
    mode = force_mode or ("sequential" if b.device.type == "cpu" else "batched")
    if mode == "sequential":
        xs, its, rsqs = [], [], []
        for i in range(b.shape[0]):
            x, it, rsq = cg(apply_one, b[i], x0=None if x0 is None else x0[i], eps=eps,
                            maxiter=maxiter, log=log)
            xs.append(x)
            its.append(it)
            rsqs.append(rsq)
        return torch.stack(xs), max(its), torch.stack(rsqs)
    if mode != "batched":
        raise ValueError(f"force_mode must be 'batched' or 'sequential', got {mode!r}")
    return cg_multi(lambda v: torch.stack([apply_one(vi) for vi in v]), b, eps=eps,
                    maxiter=maxiter, x0=x0, log=log)


def multishift_cg(apply_a: Callable, b: torch.Tensor, shifts, eps: float = 1e-19,
                  maxiter: int = 3000, log: Optional[list] = None):
    """Multi-shift CG: solve (A + sigma_k) x_k = b for all k at once.

    One Krylov space; the shifted iterates follow the Jegerlehner zeta
    recurrence (hep-lat/9612014) with the positive CG step
    a_n = rsq/(p,Ap), in the real dtype:

        zeta^{n+1} = zeta^n zeta^{n-1} a_{n-1} /
            [ a_n b_{n-1} (zeta^{n-1} - zeta^n)
              + zeta^{n-1} a_{n-1} (1 + sigma a_n) ]
        x_s  += a_n (zeta^{n+1}/zeta^n) p_s
        p_s   = zeta^{n+1} r_new + b_n (zeta^{n+1}/zeta^n)^2 p_s

    shifts must be >= 0 and A positive definite. Convergence is tested on
    the unshifted residual (the slowest). Returns (xs[k], iterations,
    |r|^2). ``log``, if given, receives one dict per solve as ``cg``'s
    does, with the number of shifts."""
    rdtype = b.real.dtype
    sigma = torch.as_tensor(np.asarray(shifts, dtype=np.float64), dtype=rdtype, device=b.device)
    ns = sigma.shape[0]

    x = torch.zeros((ns,) + tuple(b.shape), dtype=b.dtype, device=b.device)
    r = b
    p = r
    ps = b.expand((ns,) + tuple(b.shape)).clone()
    zeta = torch.ones((ns,), dtype=rdtype, device=b.device)
    zeta_prev = torch.ones_like(zeta)
    a_prev = torch.ones((), dtype=rdtype, device=b.device)
    b_prev = torch.zeros((), dtype=rdtype, device=b.device)
    rsq = torch.real(_vdot(r, r))
    bsq = max(float(torch.real(_vdot(b, b))), 1.0)
    target = _effective_eps(eps, b.dtype) * bsq

    it = 0
    rsq_h = float(rsq)
    while rsq_h > target and it < maxiter:
        ap = apply_a(p)
        a_n = rsq / torch.real(_vdot(p, ap))
        zeta_new_raw = zeta * zeta_prev * a_prev / (
            a_n * b_prev * (zeta_prev - zeta) + zeta_prev * a_prev * (1.0 + sigma * a_n))
        # freeze shifted systems whose residual |r_s|^2 ~ zeta^2 rsq is
        # already below target: their zeta underflows geometrically and
        # would poison the recurrence with 0/0 at tight tolerances
        active = (zeta * zeta) * rsq > target
        zeta_new = torch.where(active, zeta_new_raw, zeta)
        ratio = torch.where(active, zeta_new_raw / torch.where(active, zeta, torch.ones_like(zeta)),
                            torch.zeros_like(zeta))
        x = x + _bcast(a_n * ratio, ps).to(b.dtype) * ps
        r_new = r - a_n * ap
        rsq_new = torch.real(_vdot(r_new, r_new))
        b_n = rsq_new / rsq
        p = r_new + b_n * p
        ps = (_bcast(torch.where(active, zeta_new, torch.zeros_like(zeta)), ps).to(b.dtype)
              * r_new[None] + _bcast(b_n * ratio ** 2, ps).to(b.dtype) * ps)
        zeta_prev, zeta, a_prev, b_prev = zeta, zeta_new, a_n, b_n
        r, rsq = r_new, rsq_new
        rsq_h = float(rsq)
        it += 1
    if log is not None:
        log.append({"iterations": it, "rsq": rsq_h / bsq, "target": target / bsq, "shifts": ns})
    return x, it, rsq


def _bcast(coeffs, field):
    """Broadcast per-shift coefficients over field axes."""
    return coeffs.reshape((-1,) + (1,) * (field.ndim - 1))
