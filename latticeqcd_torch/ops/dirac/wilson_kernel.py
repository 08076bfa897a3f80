"""The hand-written CUDA Wilson hopping kernels and their plain version.

Replace the Pallas kernel dslash_planes of
latticeqcd_tpu/ops/dirac/wilson_pallas.py. r = 1, csw = 0, boundary
phases already in the links. Two kernels:

* wilson_hop_packed (csrc/wilson_hop_packed.cu, see there for the
  design and what bounds it): H psi_s on target-parity sites of the
  even-odd packed layout (WilsonDirac.hop_packed), the mat-vec of every
  CG iteration and of the fermion force on the HMC path, and of the
  Wilson measurement solves. ``launches`` counts its launches;
* wilson_hop (csrc/wilson_hop.cu), one thread per site, with two modes:
  full, D psi = psi - kappa H psi on [X,Y,Z,T,4,NC] (``wilson_dslash``;
  WilsonDirac.apply runs the wilson_window kernel instead,
  wilson_window_kernel.py), and packed (``hop_packed_site``), the same
  function as wilson_hop_packed. Neither mode is on a path: both stay
  built, checked and timed as yardsticks. ``site_launches`` counts them
  per mode.

The public entry points are autograd Functions. A tensor on the CPU
takes the plain PyTorch version (``dslash_reference``,
``hop_packed_reference``: rolls and einsums as in
latticeqcd_tpu/ops/dirac/wilson.py); a tensor on a CUDA device launches
the kernel, or the wrapper raises. The backward with respect to the
spinor is the kernel again (the adjoint hop is gamma5 H gamma5 with the
link roles swapped); the backward with respect to the links is written
with tensor ops: outer products of the projected half spinors with the
incoming gradient, summed over spin.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from latticeqcd_torch import _nvcc
from latticeqcd_torch.ops import rolls
from latticeqcd_torch.ops.dirac import eo_pack, gammas

DIRS = 4
launches = 0
site_launches = {"full": 0, "packed": 0}

_SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}
_FNS: dict = {}


# --------------------------------------------------------------- plain version


@functools.lru_cache(maxsize=None)
def _half_factors(dtype, device):
    vm, vp = gammas.half_spinor_factors()
    return (torch.as_tensor(vm, dtype=dtype, device=device),
            torch.as_tensor(vp, dtype=dtype, device=device))


def gamma5(psi: torch.Tensor) -> torch.Tensor:
    """gamma5 psi = diag(1, 1, -1, -1) on the spin axis (-2)."""
    return torch.cat([psi[..., :2, :], -psi[..., 2:, :]], dim=-2)


def _hop(u_fwd, u_bwd, psi, gplus, gminus):
    """sum_mu 2 Vm[mu] U_fwd(x) (Vm^dag psi)(x+mu)
            + 2 Vp[mu] U_bwd(x-mu)^dag (Vp^dag psi)(x-mu),
    with the neighbour gathers given (half-spinor form, r = 1)."""
    vm, vp = _half_factors(psi.dtype, psi.device)
    hop = 0.0
    for mu in range(DIRS):
        half = torch.einsum("sh,...sc->...hc", vm[mu].conj(), gplus(psi, mu))
        half = torch.einsum("...ab,...hb->...ha", u_fwd[mu], half)
        hop = hop + 2.0 * torch.einsum("sh,...hc->...sc", vm[mu], half)
        half = torch.einsum("sh,...sc->...hc", vp[mu].conj(), gminus(psi, mu))
        half = torch.einsum("...ba,...hb->...ha", gminus(u_bwd[mu], mu).conj(), half)
        hop = hop + 2.0 * torch.einsum("sh,...hc->...sc", vp[mu], half)
    return hop


def full_plus(f, mu):
    """f(x + mu) on the full lattice."""
    return rolls.roll(f, -1, mu)


def full_minus(f, mu):
    """f(x - mu) on the full lattice."""
    return rolls.roll(f, 1, mu)


def packed_gathers(psi_s, target_parity):
    """(gather_plus, gather_minus, scatter_minus) seen from the target-parity
    sites of the packed layout, as callables f(field, mu)."""
    lattice = (2 * psi_s.shape[0],) + tuple(psi_s.shape[1:4])
    s_t = eo_pack.offset_field(lattice, target_parity)
    return (lambda f, mu: eo_pack.gather_plus(f, mu, s_t),
            lambda f, mu: eo_pack.gather_minus(f, mu, s_t),
            lambda g, mu: eo_pack.scatter_minus(g, mu, s_t))


def hop_full_reference(u, psi):
    """Plain full-volume H psi (r = 1)."""
    return _hop(u, u, psi, full_plus, full_minus)


def dslash_reference(u, psi, kappa):
    """Plain full-volume D psi = psi - kappa H psi (r = 1)."""
    return psi - kappa * hop_full_reference(u, psi)


def hop_packed_reference(u_t, u_s, psi_s, target_parity: int):
    """Plain H psi_s on target-parity sites (packed layout, r = 1)."""
    gplus, gminus, _ = packed_gathers(psi_s, target_parity)
    return _hop(u_t, u_s, psi_s, gplus, gminus)


def _link_grads(g, psi, gplus, gminus):
    """Gradients of Re<g, H psi> (PyTorch's convention for a real loss of
    complex inputs) w.r.t. the forward links U_fwd(x) and the backward
    links U_bwd(x - mu), the latter still held at the target site x."""
    vm, vp = _half_factors(psi.dtype, psi.device)
    fwd, bwd = [], []
    for mu in range(DIRS):
        gh = torch.einsum("sh,...sc->...hc", vm[mu].conj(), g)
        ph = torch.einsum("sh,...sc->...hc", vm[mu].conj(), gplus(psi, mu))
        fwd.append(2.0 * torch.einsum("...hi,...hj->...ij", gh, ph.conj()))
        gh = torch.einsum("sh,...sc->...hc", vp[mu].conj(), g)
        ph = torch.einsum("sh,...sc->...hc", vp[mu].conj(), gminus(psi, mu))
        bwd.append(2.0 * torch.einsum("...hi,...hj->...ij", ph, gh.conj()))
    return fwd, bwd


# ----------------------------------------------------------------- the kernel


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_PACKED_ARGS = [_VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _CI, _VP]
# csrc/<name>.cu -> its C entry points (each with a _c64 and a _c128 form) and their arguments
_ENTRY_POINTS = {
    "wilson_hop": {"wilson_hop_full": [_VP, _VP, _VP, _CI, _CI, _CI, _CI, ctypes.c_double, _VP],
                   "wilson_hop_packed": _PACKED_ARGS},
    "wilson_hop_packed": {"wilson_hop_brick": _PACKED_ARGS},
}


def _fn(lib, entry, dtype):
    """The C entry point `entry` of csrc/<lib>.cu for `dtype`, its library built
    and loaded at first use."""
    key = (lib, entry, dtype)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(_nvcc.load(lib), f"{entry}_{_SUFFIX[dtype]}")
        fn.argtypes, fn.restype = _ENTRY_POINTS[lib][entry], _CI
        _FNS[key] = fn
    return fn


def _check(psi, *links, kernel="wilson_hop"):
    """Raise on anything the kernel (any of the Wilson kernels) does not take."""
    if psi.device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got {psi.device}")
    if psi.dtype not in _SUFFIX:
        raise TypeError(f"{kernel} takes complex64 or complex128, got {psi.dtype}")
    if psi.ndim != 6 or tuple(psi.shape[4:]) != (4, 3):
        raise ValueError(f"spinor must be [X,Y,Z,T,4,3], got {tuple(psi.shape)}")
    want = (DIRS,) + tuple(psi.shape[:4]) + (3, 3)
    vol = psi.shape[0] * psi.shape[1] * psi.shape[2] * psi.shape[3]
    if vol == 0 or 36 * vol >= 2**31:
        raise ValueError(f"lattice volume {vol} outside the kernel's 32-bit indexing")
    for t in (psi,) + links:
        if t.device != psi.device or t.dtype != psi.dtype:
            raise TypeError(f"{kernel} fields must share device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} fields must be contiguous")
    for u in links:
        if tuple(u.shape) != want:
            raise ValueError(f"links must be {want}, got {tuple(u.shape)}")


def _raise_on_error(err: int, lib: str, entry: str):
    if err != 0:
        raise RuntimeError(f"{lib} {entry} launch failed: CUDA error {err}")


def _dslash(u, psi, kappa):
    if psi.device.type == "cpu":
        return dslash_reference(u, psi, kappa)
    _check(psi, u)
    out = torch.empty_like(psi)
    fn = _fn("wilson_hop", "wilson_hop_full", psi.dtype)
    with torch.cuda.device(psi.device):
        err = fn(u.data_ptr(), psi.data_ptr(), out.data_ptr(), *psi.shape[:4], float(kappa),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, "wilson_hop", "wilson_hop_full")
    site_launches["full"] += 1
    return out


def _packed(lib, entry, u_t, u_s, psi_s, target_parity):
    """Launch the packed-hop entry point `entry` of csrc/<lib>.cu."""
    out = torch.empty_like(psi_s)
    fn = _fn(lib, entry, psi_s.dtype)
    with torch.cuda.device(psi_s.device):
        err = fn(u_t.data_ptr(), u_s.data_ptr(), psi_s.data_ptr(), out.data_ptr(),
                 *psi_s.shape[:4], int(target_parity), torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, lib, entry)
    return out


def _hop_packed(u_t, u_s, psi_s, target_parity):
    """The packed hop on the paths: the wilson_hop_packed kernel."""
    global launches
    if psi_s.device.type == "cpu":
        return hop_packed_reference(u_t, u_s, psi_s, target_parity)
    _check(psi_s, u_t, u_s, kernel="wilson_hop_packed")
    if psi_s.data_ptr() % 16:  # the kernel's bulk copies read 16-byte aligned rows
        psi_s = psi_s.clone()
    out = _packed("wilson_hop_packed", "wilson_hop_brick", u_t, u_s, psi_s, target_parity)
    launches += 1
    return out


def hop_packed_site(u_t, u_s, psi_s, target_parity: int):
    """The same packed hop through wilson_hop's one-thread-per-site packed
    mode (forward only), kept as the yardstick of wilson_hop_packed."""
    if psi_s.device.type == "cpu":
        return hop_packed_reference(u_t, u_s, psi_s, target_parity)
    _check(psi_s, u_t, u_s)
    out = _packed("wilson_hop", "wilson_hop_packed", u_t, u_s, psi_s, target_parity)
    site_launches["packed"] += 1
    return out


# ------------------------------------------------------------------- autograd


class WilsonDslash(torch.autograd.Function):
    """D psi = psi - kappa H psi (full volume, r = 1) through ``dslash``, the
    launch of a full-D kernel (this module's full mode, or wilson_window's);
    the spinor gradient runs ``dslash`` again."""

    @staticmethod
    def forward(ctx, u, psi, kappa, dslash):
        ctx.save_for_backward(u, psi)
        ctx.kappa, ctx.dslash = kappa, dslash
        return dslash(u, psi, kappa)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        u, psi = ctx.saved_tensors
        g = g.contiguous()
        d_u = d_psi = None
        if ctx.needs_input_grad[1]:
            d_psi = gamma5(ctx.dslash(u, gamma5(g), ctx.kappa))  # D^dag = g5 D g5
        if ctx.needs_input_grad[0]:
            fwd, bwd = _link_grads(g, psi, full_plus, full_minus)
            d_u = -ctx.kappa * torch.stack(
                [fwd[mu] + rolls.roll(bwd[mu], -1, mu) for mu in range(DIRS)])
        return d_u, d_psi, None, None


class WilsonHopPacked(torch.autograd.Function):
    """H psi_s on target-parity sites (packed even-odd layout, r = 1)."""

    @staticmethod
    def forward(ctx, u_t, u_s, psi_s, target_parity):
        ctx.save_for_backward(u_t, u_s, psi_s)
        ctx.parity = target_parity
        return _hop_packed(u_t, u_s, psi_s, target_parity)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        u_t, u_s, psi_s = ctx.saved_tensors
        g = g.contiguous()
        d_ut = d_us = d_psi = None
        if ctx.needs_input_grad[2]:
            # H_ts^dag = g5 H_st g5: the source parity becomes the target,
            # u_s supplies the forward links and u_t the backward ones
            d_psi = gamma5(_hop_packed(u_s, u_t, gamma5(g), 1 - ctx.parity))
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            gplus, gminus, scatter = packed_gathers(psi_s, ctx.parity)
            fwd, bwd = _link_grads(g, psi_s, gplus, gminus)
            d_ut = torch.stack(fwd)
            d_us = torch.stack([scatter(bwd[mu], mu) for mu in range(DIRS)])
        return d_ut, d_us, d_psi, None


def wilson_dslash(u, psi, kappa):
    """Full D psi (r = 1) through the kernel on CUDA, the plain version on the CPU."""
    return WilsonDslash.apply(u, psi, float(kappa), _dslash)


def wilson_hop_packed(u_t, u_s, psi_s, target_parity: int):
    """Packed H psi_s (r = 1) through the kernel on CUDA, the plain version on the CPU."""
    return WilsonHopPacked.apply(u_t, u_s, psi_s, int(target_parity))
