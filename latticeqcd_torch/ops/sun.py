"""SU(N) matrix algebra on batched fields.

Counterpart of latticeqcd_tpu/ops/sun.py. Every function acts on the
last two (colour) axes; leading axes are batch axes. Momenta are
traceless hermitian H, the MD evolution is U <- exp(i eps H) U and the
kinetic energy is tr(H^2).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.complex128 else torch.float32


def dagger(m: torch.Tensor) -> torch.Tensor:
    """Hermitian conjugate on the last two axes."""
    return m.transpose(-1, -2).conj()


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matrix product on the last two axes."""
    return torch.matmul(a, b)


def trace(m: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


def _eye(nc: int, m: torch.Tensor) -> torch.Tensor:
    return torch.eye(nc, dtype=m.dtype, device=m.device)


def traceless_hermitian(m: torch.Tensor) -> torch.Tensor:
    """(M + M^dag)/2 minus its trace/N: the momentum-space projection."""
    nc = m.shape[-1]
    h = 0.5 * (m + dagger(m))
    tr = trace(h) / nc
    return h - tr[..., None, None] * _eye(nc, m)


def traceless_antihermitian(m: torch.Tensor) -> torch.Tensor:
    """(M - M^dag)/2 minus its trace/N: the field-strength projection."""
    nc = m.shape[-1]
    a = 0.5 * (m - dagger(m))
    tr = trace(a) / nc
    return a - tr[..., None, None] * _eye(nc, m)


def random_hermitian_momentum(shape_prefix, nc: int, dtype=torch.complex128, device="cuda",
                              generator: Optional[torch.Generator] = None,
                              normals=None) -> torch.Tensor:
    """Traceless hermitian H with density exp(-tr H^2): complex Ginibre
    A = (re + i im)/sqrt(2), H = (A + A^dag)/2 minus its trace. The
    normals come from the Generator, or are injected as (re, im) of
    shape shape_prefix + (nc, nc)."""
    shape = tuple(shape_prefix) + (nc, nc)
    if normals is None:
        rdtype = real_dtype(dtype)
        re = torch.randn(shape, generator=generator, dtype=rdtype, device=device)
        im = torch.randn(shape, generator=generator, dtype=rdtype, device=device)
    else:
        re, im = normals
    a = torch.complex(re, im).to(dtype) / math.sqrt(2.0)
    h = 0.5 * (a + dagger(a))
    tr = trace(h) / nc
    return h - tr[..., None, None] * _eye(nc, h)


def kinetic_energy(h: torch.Tensor) -> torch.Tensor:
    """tr(H^2) summed over all batch axes."""
    return torch.sum(torch.real(trace(mul(h, h))))


def det(m: torch.Tensor) -> torch.Tensor:
    """Batched determinant; the 3x3 case by cofactors (no LU launch)."""
    if m.shape[-1] != 3:
        return torch.linalg.det(m)
    a = m[..., 0, :]
    b = m[..., 1, :]
    c = m[..., 2, :]
    return (a[..., 0] * (b[..., 1] * c[..., 2] - b[..., 2] * c[..., 1])
            - a[..., 1] * (b[..., 0] * c[..., 2] - b[..., 2] * c[..., 0])
            + a[..., 2] * (b[..., 0] * c[..., 1] - b[..., 1] * c[..., 0]))


# --------------------------------------------------------------------------
# exp(i eps H), H traceless hermitian
# --------------------------------------------------------------------------


def _expm_su2(x: torch.Tensor) -> torch.Tensor:
    """exp of a traceless antihermitian 2x2 matrix, analytically. Near
    theta = 0 both sin(theta)/theta and cos(theta) take their series, and
    the square root sees 1 there, so that the gradient stays finite on
    cold links (the square root's derivative at 0 is infinite, and the
    backward of an unselected branch would multiply it by 0)."""
    a = x[..., 0, 0].imag
    b = x[..., 0, 1].real
    c = x[..., 0, 1].imag
    theta2 = a * a + b * b + c * c
    small = theta2 < 1e-12
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cost = torch.where(small, 1.0 - theta2 / 2.0 + theta2 * theta2 / 24.0, torch.cos(theta))
    e00 = torch.complex(cost, a * sinc)
    e01 = torch.complex(b * sinc, c * sinc)
    row0 = torch.stack([e00, e01], dim=-1)
    row1 = torch.stack([-e01.conj(), e00.conj()], dim=-1)
    return torch.stack([row0, row1], dim=-2).to(x.dtype)


def _expi_su3_ch(h: torch.Tensor, eps) -> torch.Tensor:
    """exp(i Q), Q = eps H traceless hermitian 3x3, by the Cayley-Hamilton
    closed form (Morningstar-Peardon, hep-lat/0311018 sec. III) with the
    |c0| reflection and a 4th-order Taylor fallback at Q -> 0."""
    q = eps * h
    f64 = h.dtype == torch.complex128
    q2 = mul(q, q)
    c0 = det(q).real
    c1 = 0.5 * trace(q2).real

    small = c1 < (1e-8 if f64 else 1e-4)
    one = torch.ones_like(c1)
    c1s = torch.where(small, one, c1)

    c0max = 2.0 * (c1s / 3.0) ** 1.5
    negative = c0 < 0
    ratio = torch.clamp(torch.abs(c0) / c0max, 0.0, 1.0)
    theta = torch.arccos(ratio)
    u = torch.sqrt(c1s / 3.0) * torch.cos(theta / 3.0)
    w = torch.sqrt(c1s) * torch.sin(theta / 3.0)

    u2 = u * u
    w2 = w * w
    wsmall = torch.abs(w) < 0.05
    xi0 = torch.where(
        wsmall,
        1.0 - w2 / 6.0 * (1.0 - w2 / 20.0 * (1.0 - w2 / 42.0)),
        torch.sin(w) / torch.where(wsmall, one, w),
    )
    e2iu = torch.exp(2j * u)
    emiu = torch.exp(-1j * u)
    cosw = torch.cos(w)
    h0 = (u2 - w2) * e2iu + emiu * (8.0 * u2 * cosw + 2j * u * (3.0 * u2 + w2) * xi0)
    h1 = 2.0 * u * e2iu - emiu * (2.0 * u * cosw - 1j * (3.0 * u2 - w2) * xi0)
    h2 = e2iu - emiu * (cosw + 3j * u * xi0)
    denom = torch.where(small, one, 9.0 * u2 - w2)
    f0 = h0 / denom
    f1 = h1 / denom
    f2 = h2 / denom
    # c0 < 0 reflection: f_j(-c0) = (-1)^j conj(f_j(c0))
    f0 = torch.where(negative, f0.conj(), f0)
    f1 = torch.where(negative, -f1.conj(), f1)
    f2 = torch.where(negative, f2.conj(), f2)

    ident = _eye(3, h)
    out_ch = (f0[..., None, None] * ident + f1[..., None, None] * q
              + f2[..., None, None] * q2)
    iq = 1j * q
    iq2 = mul(iq, iq)
    out_taylor = ident + iq + iq2 / 2.0 + mul(iq2, iq) / 6.0 + mul(iq2, iq2) / 24.0
    return torch.where(small[..., None, None], out_taylor, out_ch).to(h.dtype)


_TAYLOR_ORDER = 10
_SCALING_SQUARINGS = 8


def _expm_taylor_ss(x: torch.Tensor) -> torch.Tensor:
    """Generic exp(X): scaling and squaring around a Taylor core."""
    nc = x.shape[-1]
    xs = x * 2.0 ** (-_SCALING_SQUARINGS)
    ident = _eye(nc, x)
    acc = ident + xs / _TAYLOR_ORDER
    for k in range(_TAYLOR_ORDER - 1, 0, -1):
        acc = ident + mul(xs, acc) / k
    for _ in range(_SCALING_SQUARINGS):
        acc = mul(acc, acc)
    return acc


def expi_hermitian(h: torch.Tensor, eps) -> torch.Tensor:
    """exp(i eps H) for traceless hermitian H (batched)."""
    if h.shape[-1] == 2:
        return _expm_su2(1j * eps * h)
    if h.shape[-1] == 3:
        return _expi_su3_ch(h, eps)
    return _expm_taylor_ss(1j * eps * h)


# --------------------------------------------------------------------------
# Group-manifold projection and random elements
# --------------------------------------------------------------------------


def _np_project_sun(w: np.ndarray) -> np.ndarray:
    """Host-side projection of a stack of matrices onto SU(N) via QR."""
    q, r = np.linalg.qr(w)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    dt = np.linalg.det(q)
    nc = w.shape[-1]
    return q / (dt ** (1.0 / nc))[..., None, None]


def random_sun_host(rng: np.random.Generator, shape_prefix, nc: int, dtype=np.complex128):
    """Random SU(N) stack on the host (hot start): the JAX package's
    numpy path, so one seed gives bit-identical links in both packages."""
    shape = tuple(shape_prefix) + (nc, nc)
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return _np_project_sun(a).astype(dtype)


def unitarity_defect(u: torch.Tensor) -> torch.Tensor:
    """max |U U^dag - 1| over the batch."""
    d = mul(u, dagger(u)) - _eye(u.shape[-1], u)
    return torch.max(torch.abs(d))


def reunitarize(u: torch.Tensor) -> torch.Tensor:
    """Project a near-SU(N) field back onto SU(N): three steps of
    W <- W (3 - W^dag W)/2, then a det-phase fix."""
    nc = u.shape[-1]
    w = u
    ident = _eye(nc, u)
    for _ in range(3):
        w = mul(w, 1.5 * ident - 0.5 * mul(dagger(w), w))
    return w / (det(w) ** (1.0 / nc))[..., None, None]
