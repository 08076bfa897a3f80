"""Molecular-dynamics integrators.

Counterpart of latticeqcd_tpu/md/integrators.py: QPQ and PQP leapfrog
and the Omelyan 2MN scheme on the state (U, H), U <- exp(i eps H) U,
H <- H + eps force(U). The step loop is a Python loop (PyTorch runs
eagerly). The Sexton-Weingarten multi-timescale variants wait for a
later slice (ROADMAP A7).
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


def run_md(u, h, force_gauge, dtau, md_steps, force_fermion=None, scheme: str = "QPQ",
           sexton_weingarten: bool = False, omelyan_lambda: float = OMELYAN_2MN_LAMBDA):
    if sexton_weingarten:
        raise NotImplementedError("Sexton-Weingarten integrators are not ported yet (ROADMAP A7)")
    if scheme == "QPQ":
        return leapfrog_qpq(u, h, force_gauge, dtau, md_steps, force_fermion)
    if scheme == "PQP":
        return leapfrog_pqp(u, h, force_gauge, dtau, md_steps, force_fermion)
    if scheme == "Omelyan":
        return omelyan_pqp(u, h, force_gauge, dtau, md_steps, force_fermion, lam=omelyan_lambda)
    raise ValueError(f"unknown MD scheme {scheme!r}")
