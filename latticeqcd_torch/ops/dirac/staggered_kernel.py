"""staggered_w: the hand-written CUDA staggered kernels and their plain versions.

Replace the Pallas kernel w_planes_window of
latticeqcd_tpu/ops/dirac/staggered_pallas.py (see csrc/staggered_w.cu and
csrc/staggered_w_fused.cu for the designs and what bounds them). On the
even-odd packed layout (fields [X/2, Y, Z, T, NC], links packed by parity
[4, X/2, Y, Z, T, NC, NC], boundary phases already in the links, every
extent even):

* hop: D psi_s = 1/2 sum_mu eta_mu (U_t,mu(x) psi_s(x+mu)
  - U_s,mu(x-mu)^dag psi_s(x-mu)) on target-parity sites
  (StaggeredDirac._packed_dslash), the hop of the fermion force;
* W:   W phi_e = m^2 phi_e - D_eo D_oe phi_e (StaggeredDirac.apply_w_packed),
  the mat-vec of every CG and multi-shift CG iteration: two launches of
  the hop kernel of csrc/staggered_w.cu, d1 = D_oe phi_e through device
  memory.

``staggered_w_fused`` computes the same W in one launch that keeps d1
on chip (csrc/staggered_w_fused.cu, thread-block clusters). It is
slower on the H100 than the two-launch W (PERF.md, sec. 6), so no path
calls it; it stays built and checked beside it.

A tensor on the CPU takes the plain PyTorch version
(``staggered_hop_packed_reference``, ``staggered_w_reference``: eo_pack
gathers and einsums as in latticeqcd_tpu/ops/dirac/staggered.py); a
tensor on a CUDA device launches the kernel, or the wrapper raises. The
hop and the two-launch W also take a leading chain axis of independent
lattices (fields [n, X/2, Y, Z, T, NC], links [n, 4, X/2, Y, Z, T, NC,
NC], HMC.step_batched): each launch serves all n chains on the card, and
on the CPU the plain version is mapped over the chains with
torch.func.vmap.
``StaggeredHopPacked`` differentiates the hop: its backward for the
field is the kernel again (D is antihermitian, so the adjoint of the
target<-source hop is minus the source<-target hop), for the links it is
eta-weighted outer products written with tensor ops.

Under a process grid (parallel/mesh.py) the fields are this rank's
blocks and the hop runs in its halo mode (``hop_packed_halo``, as
wilson_kernel.py's packed Wilson hop does): before each hop the source
field's boundary slabs are exchanged with the neighbours (two messages
per cut axis), and the kernel, or on the CPU its plain version
``hop_packed_halo_reference``, reads the neighbours outside the block
from these face buffers; the backward links' faces go once per link
tensor (wilson_kernel.link_faces). W under a grid is two halo launches
with the faces of d1 exchanged between them, the m^2 axpy fused into the
second. The backward reuses the forward's faces for the link gradient
and moves the gradient of each backward link onto the rank that holds it
with one slab more per cut axis. With a leading chain axis under a grid
(HMC.step_batched on a grid) both of the grid W's launches and the hop
run the kernel's chain-halo mode (``staggered_hop_halo_chains``): every
chain's faces in one message per direction and cut axis, one launch for
all chains; on the CPU the plain halo version and the link gradients are
mapped over the chains with torch.func.vmap.

``launches`` counts calls of csrc/staggered_w.cu's entry points outside
the halo mode, the kernels of the paths on one process (hop, forward and
backward alike, and W); ``w_launches`` counts those of its W alone (each
two CUDA launches of the hop kernel). ``halo_launches`` counts the halo
mode's launches (a grid W is two), ``chain_halo_launches`` those of its
chain-halo mode among them. ``fused_launches`` counts launches of the
one-launch W.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from latticeqcd_torch import _nvcc
from latticeqcd_torch.ops.dirac import eo_pack
from latticeqcd_torch.ops.dirac import wilson_kernel
from latticeqcd_torch.ops.dirac.wilson_kernel import MAX_CHAINS, chain_args
from latticeqcd_torch.parallel import mesh

DIRS = 4
launches = 0
w_launches = 0
halo_launches = 0
chain_halo_launches = 0
fused_launches = 0

_SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}
_VP, _CI, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the chain count and the links' and fields' chain strides of csrc/staggered_w.cu's entry points
_CHAIN_ARGS = [_CI, _LL, _LL]
# entry point -> (library, argument types)
_ENTRY_POINTS = {
    "staggered_hop_packed": ("staggered_w", [_VP] * 4 + [_CI] * 5 + _CHAIN_ARGS + [_VP]),
    "staggered_w": ("staggered_w", [_VP] * 5 + [_CI] * 4 + [ctypes.c_double] + _CHAIN_ARGS
                    + [_VP]),
    "staggered_w_fused": ("staggered_w_fused", [_VP] * 4 + [_CI] * 4 + [ctypes.c_double, _VP]),
    # the hop's fields, phi (W's axpy, or null), the extents, the parity, m^2, the partition
    # mask and the array of 12 face pointers
    "staggered_hop_halo": ("staggered_w", [_VP] * 5 + [_CI] * 5 + [ctypes.c_double, _CI, _VP,
                                                                   _VP]),
    # the chain-halo mode: after the extents and the parity the chain arguments and the array
    # of the faces' 12 chain strides, then m^2, the mask, the face pointers and the stream
    "staggered_hop_halo_chains": ("staggered_w", [_VP] * 5 + [_CI] * 5 + _CHAIN_ARGS
                                  + [_VP, ctypes.c_double, _CI, _VP, _VP]),
}


# --------------------------------------------------------------- plain version


def packed_eta_signs(lattice, parity: int) -> np.ndarray:
    """eta_mu on the parity-``parity`` packed sites, (X/2, Y, Z, T, 4) of +-1,
    by the kernel's rule: with x = 2x' + off, off = (y+z+t+parity) mod 2,
    eta_1 = 1, eta_2 = (-1)^off, eta_3 = (-1)^(off+y), eta_4 = (-1)^(off+y+z).
    On a block of a process grid (every origin even) the block's own signs are
    the block of the global field's."""
    x2, ly, lz, lt = lattice[0] // 2, lattice[1], lattice[2], lattice[3]
    off = eo_pack.offset_field(lattice, parity)
    gy = np.arange(ly)[:, None, None]
    gz = np.arange(lz)[None, :, None]
    k = np.stack(np.broadcast_arrays(np.zeros_like(off), off, off + gy, off + gy + gz), axis=-1)
    return np.broadcast_to(1.0 - 2.0 * (k % 2), (x2, ly, lz, lt, DIRS))


@functools.lru_cache(maxsize=None)
def _eta(lattice, parity, dtype, device):
    """packed_eta_signs as a real tensor on ``device``, made once."""
    return torch.as_tensor(np.array(packed_eta_signs(lattice, parity)), dtype=dtype,
                           device=device)


def _signs(psi_s, target_parity):
    """The packed KS signs of the target parity, for a source field psi_s."""
    lattice = (2 * psi_s.shape[0],) + tuple(psi_s.shape[1:4])
    return _eta(lattice, target_parity, psi_s.real.dtype, psi_s.device)


def _hop(u_t, u_s, psi_s, target_parity, gplus, gminus, glink):
    """1/2 sum_mu eta_mu (U_t,mu(x) psi_s(x+mu) - U_s,mu(x-mu)^dag psi_s(x-mu)) with the
    neighbour gathers of the spinor and of the backward links given."""
    eta = _signs(psi_s, target_parity)
    out = 0.0
    for mu in range(DIRS):
        fwd = torch.einsum("...ab,...b->...a", u_t[mu], gplus(psi_s, mu))
        bwd = torch.einsum("...ba,...b->...a", glink(u_s[mu], mu).conj(), gminus(psi_s, mu))
        out = out + 0.5 * eta[..., mu, None] * (fwd - bwd)
    return out


def staggered_hop_packed_reference(u_t, u_s, psi_s, target_parity: int):
    """Plain D psi_s on target-parity sites (packed layout), per chain over a
    leading chain axis."""
    if psi_s.ndim == 6:
        return torch.func.vmap(
            lambda a, b, c: staggered_hop_packed_reference(a, b, c, target_parity))(u_t, u_s, psi_s)
    gplus, gminus, _ = wilson_kernel.packed_gathers(psi_s, target_parity)
    return _hop(u_t, u_s, psi_s, target_parity, gplus, gminus, gminus)


def hop_packed_halo_reference(u_t, u_s, psi_s, target_parity: int, faces, link_faces):
    """Plain D psi_s on a block of a process grid (packed layout), the neighbours
    outside the block from the face buffers ``faces`` {mu: (lo, hi)} and the backward
    links' from ``link_faces`` {mu: face}; per chain over a leading chain axis."""
    if psi_s.ndim == 6:
        return torch.func.vmap(lambda a, b, c, f, l: hop_packed_halo_reference(
            a, b, c, target_parity, f, l))(u_t, u_s, psi_s, faces, link_faces)
    return _hop(u_t, u_s, psi_s, target_parity,
                *wilson_kernel.halo_gathers(psi_s, target_parity, faces, link_faces))


def staggered_w_reference(u_e, u_o, phi_e, mass: float):
    """Plain W phi_e = m^2 phi_e - D_eo D_oe phi_e on packed even sites (per chain
    over a leading chain axis)."""
    d1 = staggered_hop_packed_reference(u_o, u_e, phi_e, 1)
    return mass ** 2 * phi_e - staggered_hop_packed_reference(u_e, u_o, d1, 0)


def _outer_grads(g, psi_s, target_parity, gplus, gminus):
    """(d u_t per mu, the gradients of the backward links per mu still held at the
    target sites x) of Re<g, D psi_s>, with the spinor gathers given."""
    eta = _signs(psi_s, target_parity)
    d_ut, bwd = [], []
    for mu in range(DIRS):
        ge = 0.5 * eta[..., mu, None] * g
        d_ut.append(torch.einsum("...i,...j->...ij", ge, gplus(psi_s, mu).conj()))
        bwd.append(-torch.einsum("...i,...j->...ij", gminus(psi_s, mu), ge.conj()))
    return d_ut, bwd


def _link_grads(g, psi_s, target_parity):
    """Gradients of Re<g, D psi_s> (PyTorch's convention for a real loss of
    complex inputs) w.r.t. the forward links u_t and the backward links u_s,
    per chain over a leading chain axis."""
    if psi_s.ndim == 6:
        return torch.func.vmap(lambda a, b: _link_grads(a, b, target_parity))(g, psi_s)
    gplus, gminus, scatter = wilson_kernel.packed_gathers(psi_s, target_parity)
    d_ut, bwd = _outer_grads(g, psi_s, target_parity, gplus, gminus)
    return torch.stack(d_ut), torch.stack([scatter(bwd[mu], mu) for mu in range(DIRS)])


def _halo_link_grads(g, psi_s, target_parity, faces):
    """(d u_t, moving, staying) of Re<g, D psi_s> on a block from the faces of psi_s (as
    wilson_kernel.halo_link_grads), per chain over a leading chain axis."""
    if psi_s.ndim == 6:
        return torch.func.vmap(lambda a, b, f: _halo_link_grads(a, b, target_parity, f))(
            g, psi_s, faces)
    gplus, gminus, _ = wilson_kernel.halo_gathers(psi_s, target_parity, faces, {})
    d_ut, bwd = _outer_grads(g, psi_s, target_parity, gplus, gminus)
    return (torch.stack(d_ut),) + tuple(wilson_kernel.split_backward(bwd, psi_s, target_parity))


def _grid_link_grads(g, psi_s, target_parity, faces, grid):
    """(d u_t, d u_s) of Re<g, D psi_s> on a block, from the forward's faces; the
    gradients of the backward links move across the block's faces by one more slab
    per cut axis (wilson_kernel.scatter_across_faces, every chain's in it)."""
    d_ut, moving, staying = _halo_link_grads(g, psi_s, target_parity, faces)
    return d_ut, wilson_kernel.scatter_across_faces(moving, staying, grid, psi_s.ndim - 5)


# ----------------------------------------------------------------- the kernel


@functools.lru_cache(maxsize=None)
def _entry(name: str, dtype):
    """The C entry point `name` for `dtype`, its library built and loaded at first use."""
    lib, argtypes = _ENTRY_POINTS[name]
    fn = getattr(_nvcc.load(lib), f"{name}_{_SUFFIX[dtype]}")
    fn.argtypes, fn.restype = argtypes, _CI
    return fn


def _check(psi, *links, chains=False):
    """Raise on anything the kernel does not take; with ``chains`` a leading
    chain axis is allowed."""
    if psi.device.type != "cuda":
        raise ValueError(f"staggered_w runs on CUDA tensors, got {psi.device}")
    if psi.dtype not in _SUFFIX:
        raise TypeError(f"staggered_w takes complex64 or complex128, got {psi.dtype}")
    lead = psi.ndim - 5
    if lead not in ((0, 1) if chains else (0,)) or psi.shape[-1] != 3:
        raise ValueError(f"packed field must be [{'(n,) ' if chains else ''}X/2,Y,Z,T,3], "
                         f"got {tuple(psi.shape)}")
    if lead and not 1 <= psi.shape[0] <= MAX_CHAINS:
        raise ValueError(f"staggered_w takes 1 to {MAX_CHAINS} chains, got {psi.shape[0]}")
    lat = tuple(psi.shape[lead:lead + 4])
    if any(l % 2 for l in lat[1:]):
        raise ValueError(f"the packed staggered kernel needs every lattice extent even, "
                         f"got {(2 * lat[0],) + lat[1:]}")
    vol = lat[0] * lat[1] * lat[2] * lat[3]
    if vol == 0 or 36 * vol >= 2**31:
        raise ValueError(f"packed volume {vol} outside the kernel's 32-bit indexing")
    want = tuple(psi.shape[:lead]) + (DIRS,) + lat + (3, 3)
    for t in (psi,) + links:
        if t.device != psi.device or t.dtype != psi.dtype:
            raise TypeError("staggered_w fields must share device and dtype")
        if not t.is_contiguous():
            raise ValueError("staggered_w fields must be contiguous")
    for u in links:
        if tuple(u.shape) != want:
            raise ValueError(f"packed links must be {want}, got {tuple(u.shape)}")


def _raise_on_error(err: int, entry: str):
    if err == -1:
        raise RuntimeError(f"{entry}: no cluster of the kernel's tile fits on this device")
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def _hop_packed(u_t, u_s, psi_s, target_parity):
    global launches
    if psi_s.device.type == "cpu":
        return staggered_hop_packed_reference(u_t, u_s, psi_s, target_parity)
    _check(psi_s, u_t, u_s, chains=True)
    out = torch.empty_like(psi_s)
    with torch.cuda.device(psi_s.device):
        err = _entry("staggered_hop_packed", psi_s.dtype)(
            u_t.data_ptr(), u_s.data_ptr(), psi_s.data_ptr(), out.data_ptr(), *psi_s.shape[-5:-1],
            int(target_parity), *chain_args(psi_s, u_t, 1),
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, "staggered_hop_packed")
    launches += 1
    return out


def _w(u_e, u_o, phi_e, mass):
    """W on the paths: csrc/staggered_w.cu's two launches, d1 through device memory;
    each launch serves all chains of a leading chain axis."""
    global launches, w_launches
    if phi_e.device.type == "cpu":
        return staggered_w_reference(u_e, u_o, phi_e, mass)
    _check(phi_e, u_e, u_o, chains=True)
    d1 = torch.empty_like(phi_e)
    out = torch.empty_like(phi_e)
    with torch.cuda.device(phi_e.device):
        err = _entry("staggered_w", phi_e.dtype)(
            u_e.data_ptr(), u_o.data_ptr(), phi_e.data_ptr(), d1.data_ptr(), out.data_ptr(),
            *phi_e.shape[-5:-1], float(mass) ** 2, *chain_args(phi_e, u_e, 1),
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, "staggered_w")
    launches += 1
    w_launches += 1
    return out


def hop_packed_halo(u_t, u_s, psi_s, target_parity: int, faces, link_faces, phi=None,
                    mass: float = 0.0):
    """D psi_s on this rank's block of a process grid (with ``phi``: m^2 phi - D psi_s,
    W's second half): ``faces`` {mu: (lo, hi)} holds, for each cut axis mu, the -mu
    neighbour's last and the +mu neighbour's first slab of psi_s with axis mu removed,
    ``link_faces`` {mu: the -mu neighbour's last slab of u_s[mu]}. The kernel's halo mode
    on CUDA (one launch; with a leading chain axis, on fields and faces alike, its
    chain-halo mode, one launch for all chains), the plain version on the CPU."""
    global halo_launches, chain_halo_launches
    if psi_s.device.type == "cpu":
        out = hop_packed_halo_reference(u_t, u_s, psi_s, target_parity, faces, link_faces)
        return out if phi is None else mass ** 2 * phi - out
    chained = psi_s.ndim == 6
    _check(psi_s, u_t, u_s, chains=chained)
    if phi is not None and (phi.shape != psi_s.shape or phi.dtype != psi_s.dtype
                            or phi.device != psi_s.device or not phi.is_contiguous()):
        raise ValueError("the axpy field must be contiguous and match the spinor")
    wilson_kernel._check_faces(psi_s, u_s, faces, link_faces)
    mask, ptrs, strides = wilson_kernel.face_args(faces, link_faces, chained)
    entry = "staggered_hop_halo_chains" if chained else "staggered_hop_halo"
    chains = (*chain_args(psi_s, u_t, 1), strides) if chained else ()
    out = torch.empty_like(psi_s)
    with torch.cuda.device(psi_s.device):
        err = _entry(entry, psi_s.dtype)(
            u_t.data_ptr(), u_s.data_ptr(), psi_s.data_ptr(),
            None if phi is None else phi.data_ptr(), out.data_ptr(), *psi_s.shape[-5:-1],
            int(target_parity), *chains, float(mass) ** 2, mask, ptrs,
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, entry)
    halo_launches += 1
    chain_halo_launches += chained
    return out


def _grid_hop(u_t, u_s, psi_s, target_parity, grid):
    """(D psi_s, the faces of psi_s) on a block of ``grid``: the faces exchanged (every
    chain's in one message per direction and cut axis), then the halo mode."""
    faces = mesh.exchange_faces(psi_s, grid, lead=psi_s.ndim - 5)
    return hop_packed_halo(u_t, u_s, psi_s, target_parity, faces,
                           wilson_kernel.link_faces(u_s, grid)), faces


def _grid_w(u_e, u_o, phi_e, mass, grid):
    """W phi_e on a block of ``grid``: d1 = D_oe phi_e by the halo mode, the faces of d1
    exchanged, then m^2 phi_e - D_eo d1 by the halo mode with the axpy."""
    d1, _ = _grid_hop(u_o, u_e, phi_e, 1, grid)
    return hop_packed_halo(u_e, u_o, d1, 0, mesh.exchange_faces(d1, grid, lead=d1.ndim - 5),
                           wilson_kernel.link_faces(u_o, grid), phi=phi_e, mass=mass)


def staggered_w_fused(u_e, u_o, phi_e, mass: float):
    """The same W in one launch of csrc/staggered_w_fused.cu, d1 kept on chip
    (no d1 buffer), on a CUDA tensor; the plain version on the CPU. Built and
    checked beside the paths' W, which it does not beat (PERF.md, sec. 6)."""
    global fused_launches
    if phi_e.device.type == "cpu":
        return staggered_w_reference(u_e, u_o, phi_e, mass)
    _check(phi_e, u_e, u_o)
    out = torch.empty_like(phi_e)
    with torch.cuda.device(phi_e.device):
        err = _entry("staggered_w_fused", phi_e.dtype)(
            u_e.data_ptr(), u_o.data_ptr(), phi_e.data_ptr(), out.data_ptr(), *phi_e.shape[:4],
            float(mass) ** 2, torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, "staggered_w_fused")
    fused_launches += 1
    return out


# ------------------------------------------------------------------- autograd


class StaggeredHopPacked(torch.autograd.Function):
    """D psi_s on target-parity sites (packed even-odd layout), with or without a
    leading chain axis."""

    @staticmethod
    def forward(ctx, u_t, u_s, psi_s, target_parity):
        ctx.save_for_backward(u_t, u_s, psi_s)
        ctx.parity = target_parity
        ctx.grid = mesh.sharded()
        if ctx.grid is None:
            return _hop_packed(u_t, u_s, psi_s, target_parity)
        out, ctx.faces = _grid_hop(u_t, u_s, psi_s, target_parity, ctx.grid)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        u_t, u_s, psi_s = ctx.saved_tensors
        g = g.contiguous()
        grid = ctx.grid
        d_ut = d_us = d_psi = None
        if ctx.needs_input_grad[2]:
            # D_ts^dag = -D_st: the source parity becomes the target, u_s
            # supplies the forward links and u_t the backward ones
            if grid is None:
                d_psi = -_hop_packed(u_s, u_t, g, 1 - ctx.parity)
            else:
                d_psi = -_grid_hop(u_s, u_t, g, 1 - ctx.parity, grid)[0]
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            if grid is None:
                d_ut, d_us = _link_grads(g, psi_s, ctx.parity)
            else:
                d_ut, d_us = _grid_link_grads(g, psi_s, ctx.parity, ctx.faces, grid)
        return d_ut, d_us, d_psi, None


def staggered_hop_packed(u_t, u_s, psi_s, target_parity: int):
    """Packed D psi_s through the kernel on CUDA, the plain version on the CPU;
    under a process grid the halo mode on this rank's block."""
    return StaggeredHopPacked.apply(u_t, u_s, psi_s, int(target_parity))


def staggered_w(u_e, u_o, phi_e, mass: float):
    """Packed W phi_e through the two-launch kernel on CUDA, the plain version
    on the CPU; under a process grid two halo launches on this rank's block. Not
    differentiable: callers that need a gradient compose two
    ``staggered_hop_packed`` (StaggeredDirac.apply_w_packed does)."""
    grid = mesh.sharded()
    if grid is not None:
        return _grid_w(u_e, u_o, phi_e, float(mass), grid)
    return _w(u_e, u_o, phi_e, float(mass))
