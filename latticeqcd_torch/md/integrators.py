"""Molecular-dynamics integrators.

Counterpart of latticeqcd_tpu/md/integrators.py: QPQ and PQP leapfrog,
the Omelyan 2MN scheme and their Sexton-Weingarten multi-timescale
forms (the gauge force on a scale nsw times finer than the fermion
force) on the state (U, H), U <- exp(i eps H) U, H <- H + eps force(U).
The step loops are Python loops (PyTorch runs eagerly).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from latticeqcd_torch.ops import sun

# Omelyan-Mryglod-Folk 2nd-order minimum-norm coefficient (hep-lat/0505020 eq. 31)
OMELYAN_2MN_LAMBDA = 0.1931833275037836


def update_links(u, h, eps):
    """U <- exp(i eps H) U for all four directions."""
    return torch.matmul(sun.expi_hermitian(h, eps), u)


def leapfrog_qpq(u, h, force_gauge: Callable, dtau: float, md_steps: int,
                 force_fermion: Optional[Callable] = None):
    """[U(1/2) P(1) U(1/2)] x md_steps."""
    for _ in range(md_steps):
        u = update_links(u, h, 0.5 * dtau)
        h = h + dtau * force_gauge(u)
        if force_fermion is not None:
            h = h + dtau * force_fermion(u)
        u = update_links(u, h, 0.5 * dtau)
    return u, h


def leapfrog_pqp(u, h, force_gauge: Callable, dtau: float, md_steps: int,
                 force_fermion: Optional[Callable] = None):
    """[P(1/2) U(1) P(1/2)] x md_steps."""
    for _ in range(md_steps):
        h = h + 0.5 * dtau * force_gauge(u)
        if force_fermion is not None:
            h = h + 0.5 * dtau * force_fermion(u)
        u = update_links(u, h, dtau)
        h = h + 0.5 * dtau * force_gauge(u)
        if force_fermion is not None:
            h = h + 0.5 * dtau * force_fermion(u)
    return u, h


def omelyan_pqp(u, h, force_gauge: Callable, dtau: float, md_steps: int,
                force_fermion: Optional[Callable] = None, lam: float = OMELYAN_2MN_LAMBDA):
    """P(lam e) U(e/2) P((1-2 lam) e) U(e/2) P(lam e) per step, with the
    adjacent lam kicks of consecutive steps merged into one 2 lam kick."""

    def kick(u, h, eps):
        h = h + eps * force_gauge(u)
        if force_fermion is not None:
            h = h + eps * force_fermion(u)
        return h

    h = kick(u, h, lam * dtau)
    for i in range(md_steps):
        u = update_links(u, h, 0.5 * dtau)
        h = kick(u, h, (1.0 - 2.0 * lam) * dtau)
        u = update_links(u, h, 0.5 * dtau)
        h = kick(u, h, (lam if i == md_steps - 1 else 2.0 * lam) * dtau)
    return u, h


def _gauge_leapfrog(u, h, force_gauge, eps, n, force_fine=None):
    """n gauge-only QPQ steps of size eps; force_fine is an extra force on
    this fine scale."""
    for _ in range(n):
        u = update_links(u, h, 0.5 * eps)
        f = force_gauge(u)
        if force_fine is not None:
            f = f + force_fine(u)
        h = h + eps * f
        u = update_links(u, h, 0.5 * eps)
    return u, h


def _check_nsw(nsw: int) -> None:
    if nsw % 2 != 0:
        raise ValueError(f"Nsw must be even, got {nsw}")


def leapfrog_qpq_sw(u, h, force_gauge: Callable, dtau: float, md_steps: int,
                    force_fermion: Callable, nsw: int = 2,
                    force_fine: Optional[Callable] = None):
    """Sexton-Weingarten QPQ: per step nsw/2 gauge steps of dtau/nsw, one
    fermion kick of dtau, nsw/2 gauge steps. nsw must be even."""
    _check_nsw(nsw)
    for _ in range(md_steps):
        u, h = _gauge_leapfrog(u, h, force_gauge, dtau / nsw, nsw // 2, force_fine)
        h = h + dtau * force_fermion(u)
        u, h = _gauge_leapfrog(u, h, force_gauge, dtau / nsw, nsw // 2, force_fine)
    return u, h


def omelyan_sw(u, h, force_gauge: Callable, dtau: float, md_steps: int,
               force_fermion: Callable, nsw: int = 2, lam: float = OMELYAN_2MN_LAMBDA,
               force_fine: Optional[Callable] = None):
    """The Omelyan 2MN scheme on the fermion scale with each link drift
    replaced by a nested gauge leapfrog:

        P_f(lam e) G(e/2) P_f((1-2 lam) e) G(e/2) P_f(lam e)

    where G(t) is nsw/2 gauge QPQ steps of t/(nsw/2), and the adjacent lam
    kicks of consecutive steps merge. nsw must be even."""
    _check_nsw(nsw)
    eps = 0.5 * dtau / (nsw // 2)
    h = h + lam * dtau * force_fermion(u)
    for i in range(md_steps):
        u, h = _gauge_leapfrog(u, h, force_gauge, eps, nsw // 2, force_fine)
        h = h + (1.0 - 2.0 * lam) * dtau * force_fermion(u)
        u, h = _gauge_leapfrog(u, h, force_gauge, eps, nsw // 2, force_fine)
        h = h + (lam if i == md_steps - 1 else 2.0 * lam) * dtau * force_fermion(u)
    return u, h


def run_md(u, h, force_gauge, dtau, md_steps, force_fermion=None, scheme: str = "QPQ",
           sexton_weingarten: bool = False, nsw: int = 2,
           omelyan_lambda: float = OMELYAN_2MN_LAMBDA, force_fine=None):
    """Dispatch on the scheme; force_fine (a fine-scale extra force) only
    acts with sexton_weingarten."""
    if sexton_weingarten and scheme == "PQP":
        raise ValueError("PQP update with SextonWeingarten is not supported")
    if sexton_weingarten and scheme in ("QPQ", "Omelyan") and force_fermion is None:
        raise ValueError("The quench update does not need the SextonWeingarten method")
    if scheme == "QPQ":
        if sexton_weingarten:
            return leapfrog_qpq_sw(u, h, force_gauge, dtau, md_steps, force_fermion, nsw,
                                   force_fine=force_fine)
        return leapfrog_qpq(u, h, force_gauge, dtau, md_steps, force_fermion)
    if scheme == "PQP":
        return leapfrog_pqp(u, h, force_gauge, dtau, md_steps, force_fermion)
    if scheme == "Omelyan":
        if sexton_weingarten:
            return omelyan_sw(u, h, force_gauge, dtau, md_steps, force_fermion, nsw=nsw,
                              lam=omelyan_lambda, force_fine=force_fine)
        return omelyan_pqp(u, h, force_gauge, dtau, md_steps, force_fermion, lam=omelyan_lambda)
    raise ValueError(f"unknown MD scheme {scheme!r}")
