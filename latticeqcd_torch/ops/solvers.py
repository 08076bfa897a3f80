"""Krylov solvers for the fermion solves: CG, batched CG, multi-shift CG and BiCGStab.

Counterpart of latticeqcd_tpu/ops/solvers.py ``cg``, ``cg_multi``,
``cg_multi_auto``, ``multishift_cg`` and ``bicgstab``, and of
``multishift_cg`` under jax.vmap
(``multishift_cg_multi``, the independent chains of HMC.step_batched):
stopping criterion
|r|^2 < eps * max(|b|^2, 1), eps clamped per dtype to an attainable
target, and for ``cg`` and ``cg_multi`` in reduced precision
verified-exit restarts gated on the true residual (per right-hand side
in ``cg_multi``). Each loop reads its exit test to the host once per
iteration (one device sync per iteration, for the whole batch in
``cg_multi``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from latticeqcd_torch.parallel.mesh import global_sum

# Reduced precision: the attainable relative TRUE |r|^2, and how many
# restarts from the true residual may run (the JAX package's numbers).
_N_RESTARTS = {torch.complex64: 2, torch.float32: 2}
_VERIFY_FLOOR = 3e-11


def _vdot(a, b):
    return global_sum(torch.sum(a.conj() * b))


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


def bicgstab(apply_a: Callable, b: torch.Tensor, x0=None, eps: float = 1e-19,
             maxiter: int = 3000):
    """BiCGStab for general (non-hermitian) A, e.g. the Wilson D itself; returns
    (x, iterations, |r|^2). Two applications of A per iteration (one more for
    the initial residual b - A x0), one host read of |r|^2 per iteration."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_a(x) if x0 is not None else b
    rhat = r
    rho = _vdot(rhat, r)
    p = r
    rsq = torch.real(_vdot(r, r))
    target = _effective_eps(eps, b.dtype) * max(float(torch.real(_vdot(b, b))), 1.0)
    it = 0
    while float(rsq) > target and it < maxiter:
        v = apply_a(p)
        alpha = _safe_div(rho, _vdot(rhat, v))
        s = r - alpha * v
        t = apply_a(s)
        # breakdown guards: s == 0 (converged at the alpha half step) makes
        # omega 0/0; omega = 0 then yields r = s = 0 and a clean exit instead
        # of a NaN-poisoned x. Likewise rho/omega -> beta.
        omega = _safe_div(_vdot(t, s), _vdot(t, t))
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho_new = _vdot(rhat, r)
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        rho = rho_new
        rsq = torch.real(_vdot(r, r))
        it += 1
    return x, it, rsq


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
        return global_sum(torch.real(torch.sum(u.conj() * v, dim=axes)))

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
    does, with the number of shifts. It is ``multishift_cg_multi`` on one
    system."""
    xs, it, rsq = multishift_cg_multi(lambda v: apply_a(v[0])[None], b[None], shifts, eps=eps,
                                      maxiter=maxiter, log=log)
    return xs[:, 0], it, rsq[0]


def multishift_cg_multi(apply_a: Callable, b: torch.Tensor, shifts, eps: float = 1e-19,
                        maxiter: int = 3000, log: Optional[list] = None):
    """``multishift_cg`` for a stack of independent systems: b has a leading
    chain axis (n, ...) and ``apply_a`` maps the stack, chain i with its own
    operator A_i. Each chain carries its own CG steps, zeta recurrences and
    exit: a chain whose unshifted |r|^2 has met its target is frozen (its
    state no longer changes) while the others run, so each solves as it would
    alone, up to rounding; that is multishift_cg under jax.vmap, whose
    while_loop runs until every chain is done. One host read per iteration
    tests every chain. Returns (xs [n_shifts, n, ...], iterations, per-chain
    |r|^2); ``log``, if given, receives one dict per solve with the worst
    chain's relative |r|^2, the number of shifts and the number of chains."""
    rdtype = b.real.dtype
    n = b.shape[0]
    axes = tuple(range(1, b.ndim))

    def rdot(u, v):
        return global_sum(torch.real(torch.sum(u.conj() * v, dim=axes)))

    def per_chain(c):  # [n] or [ns, n] coefficients over a chain's field axes
        return c.reshape(tuple(c.shape) + (1,) * (b.ndim - 1)).to(b.dtype)

    sigma = torch.as_tensor(np.asarray(shifts, dtype=np.float64), dtype=rdtype,
                            device=b.device)[:, None]
    ns = sigma.shape[0]
    x = torch.zeros((ns,) + tuple(b.shape), dtype=b.dtype, device=b.device)
    r = b
    p = r
    ps = b.expand((ns,) + tuple(b.shape)).clone()
    zeta = torch.ones((ns, n), dtype=rdtype, device=b.device)
    zeta_prev = torch.ones_like(zeta)
    a_prev = torch.ones((n,), dtype=rdtype, device=b.device)
    b_prev = torch.zeros((n,), dtype=rdtype, device=b.device)
    rsq = rdot(r, r)
    bsq = torch.clamp(rdot(b, b), min=1.0)
    target = _effective_eps(eps, b.dtype) * bsq
    zero = torch.zeros_like(rsq)

    it = 0
    live = rsq > target
    while it < maxiter and bool(torch.any(live)):
        ap = apply_a(p)
        a_n = torch.where(live, _safe_div(rsq, rdot(p, ap)), zero)
        zeta_new_raw = zeta * zeta_prev * a_prev / (
            a_n * b_prev * (zeta_prev - zeta) + zeta_prev * a_prev * (1.0 + sigma * a_n))
        # freeze shifted systems whose residual |r_s|^2 ~ zeta^2 rsq is already below target
        # (their zeta underflows geometrically and would poison the recurrence with 0/0 at
        # tight tolerances), and every shift of a frozen chain
        active = ((zeta * zeta) * rsq > target) & live
        zeta_new = torch.where(active, zeta_new_raw, zeta)
        ratio = torch.where(active, zeta_new_raw / torch.where(active, zeta, torch.ones_like(zeta)),
                            torch.zeros_like(zeta))
        x = x + per_chain(a_n * ratio) * ps
        r_new = r - per_chain(a_n) * ap
        rsq_new = rdot(r_new, r_new)
        b_n = torch.where(live, _safe_div(rsq_new, rsq), zero)
        p = torch.where(live.reshape((n,) + (1,) * (b.ndim - 1)), r_new + per_chain(b_n) * p, p)
        ps = (per_chain(torch.where(active, zeta_new, torch.zeros_like(zeta))) * r_new[None]
              + per_chain(b_n * ratio ** 2) * ps)
        zeta_prev, zeta = torch.where(live, zeta, zeta_prev), zeta_new
        a_prev, b_prev = torch.where(live, a_n, a_prev), torch.where(live, b_n, b_prev)
        r, rsq = r_new, rsq_new
        live = rsq > target
        it += 1
    if log is not None:
        log.append({"iterations": it, "rsq": float(torch.max(rsq / bsq)),
                    "target": float(torch.max(target / bsq)), "shifts": ns, "rhs": n})
    return x, it, rsq
