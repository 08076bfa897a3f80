"""Lanczos eigenvalue estimation for Hermitian lattice operators.

Counterpart of latticeqcd_tpu/ops/eigen.py (``_lanczos_basis``,
``lanczos_tridiag``, ``extreme_eigs``, ``ritz_pairs_low``,
``deflation_guess``): the spectral guard of the RHMC checks that the
rational approximation's window covers the spectrum of W on the starting
configuration; the Dirac-spectrum measurement takes the lowest Ritz
values, and the staggered measurement solves can start from a low-mode
guess. After m operator applications the Krylov Ritz values bracket both
spectral ends. The recurrence keeps its basis on the field's device with
two-pass full reorthogonalization (classical Gram-Schmidt twice), each
pass one matrix-vector product over the stacked basis; only the m x m
tridiagonal eigenproblem runs on the host, with numpy in float64. Under
a process grid the basis is this rank's block, every inner product and
re-orthogonalisation coefficient is a global sum (bitwise the same on
every rank), so the tridiagonal, and its eigenproblem, are the same
host data on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from latticeqcd_torch.parallel.mesh import global_sum


def _inner(a, b):
    """Global <a, b> = sum conj(a) b (over the ranks of a process grid)."""
    return global_sum(torch.sum(a.conj() * b))


@torch.no_grad()
def _lanczos_basis(matvec, v0, m: int):
    """m-step recurrence returning (basis, alphas, betas, valid): valid[j]
    marks steps unaffected by an earlier breakdown (after one, basis rows
    are zero and alphas 0)."""
    nrm = torch.sqrt(torch.real(_inner(v0, v0)))
    v0 = v0 / nrm.to(v0.dtype)
    basis = torch.zeros((m,) + tuple(v0.shape), dtype=v0.dtype, device=v0.device)
    basis[0] = v0
    flat = basis.view(m, -1)
    alphas = torch.zeros((m,), dtype=nrm.dtype, device=v0.device)
    betas = torch.zeros_like(alphas)
    valid = torch.zeros((m,), dtype=torch.bool, device=v0.device)
    valid[0] = True
    tiny = torch.tensor(1e-30, dtype=nrm.dtype, device=v0.device)
    floor = torch.tensor(1e-300, dtype=nrm.dtype, device=v0.device)
    for j in range(m):
        v = basis[j]
        w = matvec(v)
        alphas[j] = torch.real(_inner(v, w))
        for _ in range(2):
            coef = global_sum(flat.conj() @ w.reshape(-1))
            w = w - (coef @ flat).view(w.shape)
        beta = torch.sqrt(torch.real(_inner(w, w)))
        betas[j] = beta
        ok = beta > tiny
        if j + 1 < m:
            basis[j + 1] = torch.where(ok, w / torch.maximum(beta, floor).to(w.dtype),
                                       torch.zeros_like(w))
            valid[j + 1] = valid[j] & ok
    return basis, alphas, betas, valid


def lanczos_tridiag(matvec, v0, m: int):
    """m-step Hermitian Lanczos with full reorthogonalization.

    Returns (alpha[m], beta[m]): alpha are the tridiagonal diagonals,
    beta[j] couples step j to j+1 (beta[m-1] is the final residual norm,
    not part of T_m). A breakdown (beta ~ 0: an exact invariant subspace)
    zeroes the remaining basis vectors; extreme_eigs truncates there."""
    _, alphas, betas, _ = _lanczos_basis(matvec, v0, m)
    return alphas, betas


def extreme_eigs(matvec, v0, m: int = 32, breakdown_tol: float = 1e-10):
    """Host-level (lambda_min, lambda_max) Ritz estimates after m Lanczos
    steps, the tridiagonal truncated at the first interior breakdown.
    Ritz values approach the spectrum from inside: lambda_max is an
    underestimate (callers apply a safety factor) and lambda_min an
    overestimate."""
    alphas, betas = lanczos_tridiag(matvec, v0, m)
    a = alphas.cpu().numpy().astype(np.float64)
    b = betas.cpu().numpy().astype(np.float64)
    scale = max(float(np.abs(a).max(initial=0.0)), float(b.max(initial=0.0)), 1.0)
    k = m
    for j in range(m - 1):  # b[m-1] never couples inside T_m
        if b[j] < breakdown_tol * scale:
            k = j + 1
            break
    t = np.diag(a[:k])
    if k > 1:
        t += np.diag(b[: k - 1], 1) + np.diag(b[: k - 1], -1)
    ev = np.linalg.eigvalsh(t)
    return float(ev[0]), float(ev[-1])


def _tridiagonal_eigh(alphas, betas, valid):
    """Eigenpairs (ascending, float64 numpy) of the Lanczos tridiagonal, on
    the host. Steps after a breakdown (valid False) get a diagonal sentinel
    scaled by the spectrum, 1e3 (max|alpha| + 2 max beta + 1), above every
    genuine Ritz value (each lies below max|alpha| + 2 max beta), and no
    coupling, so they sort past the genuine values without disturbing them.
    (The JAX package's 1e30 in the field's dtype leaves a complex64
    eigensolve no digits for the genuine values; ROADMAP C2.)"""
    a = alphas.cpu().numpy().astype(np.float64)
    b = betas.cpu().numpy().astype(np.float64)
    ok = valid.cpu().numpy()
    sentinel = 1e3 * (float(np.abs(a[ok]).max(initial=0.0)) + 2.0 * float(b.max(initial=0.0))
                      + 1.0)
    off = b[:-1] * ok[1:]
    t = np.diag(np.where(ok, a, sentinel)) + np.diag(off, 1) + np.diag(off, -1)
    return np.linalg.eigh(t)


def ritz_pairs_low(matvec, v0, m: int, k: int):
    """k lowest Ritz pairs of a Hermitian positive semi-definite operator
    from m Lanczos steps: (evals[k] in the field's real dtype, vecs[(k,
    *v0.shape)]), ascending. The tridiagonal goes to the host in float64
    (``_tridiagonal_eigh``); steps after a breakdown sort past the genuine
    values and their basis rows are zero, so a deflation guess takes
    nothing from them. The basis lives only inside this call."""
    basis, alphas, betas, valid = _lanczos_basis(matvec, v0, m)
    w, y = _tridiagonal_eigh(alphas, betas, valid)
    yk = torch.as_tensor(y[:, :k], dtype=basis.dtype, device=basis.device)
    vecs = torch.einsum("jk,j...->k...", yk, basis)
    return torch.as_tensor(w[:k], dtype=alphas.dtype, device=basis.device), vecs


def deflation_guess(evals, vecs, b):
    """Galerkin initial guess from Ritz pairs for a stack of right-hand
    sides: x0_i = sum_k <v_k, b_i> / lambda_k v_k. Exact on the spanned
    subspace and zero outside it, so the CG that follows corrects any Ritz
    imprecision; sentinel eigenvalues divide to ~0."""
    c = global_sum(torch.einsum("k...,n...->nk", vecs.conj(), b))
    return torch.einsum("nk,k...->n...", c / evals[None, :].to(c.dtype), vecs)
