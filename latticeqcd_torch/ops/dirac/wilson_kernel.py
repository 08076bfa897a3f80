"""The hand-written CUDA Wilson hopping kernels and their plain version.

Replace the Pallas kernel dslash_planes of
latticeqcd_tpu/ops/dirac/wilson_pallas.py. csw = 0, boundary phases
already in the links. Two kernels:

* wilson_hop_packed (csrc/wilson_hop_packed.cu, see there for the
  design and what bounds it): H psi_s on target-parity sites of the
  even-odd packed layout (WilsonDirac.hop_packed), the mat-vec of every
  CG iteration and of the fermion force on the HMC path, and of the
  Wilson measurement solves. At r = 1 the half-spinor form; at any
  other Wilson r its r mode (the ``_r`` entry points), which applies
  (r -+ g_mu) in full. ``launches`` counts its launches at any r,
  ``r_launches`` those of the r mode;
* wilson_hop (csrc/wilson_hop.cu, r = 1 only), one thread per site, with two modes:
  full, D psi = psi - kappa H psi on [X,Y,Z,T,4,NC] (``wilson_dslash``;
  WilsonDirac.apply runs the wilson_window kernel instead,
  wilson_window_kernel.py), and packed (``hop_packed_site``), the same
  function as wilson_hop_packed. Neither mode is on a path: both stay
  built, checked and timed as yardsticks. ``site_launches`` counts them
  per mode.

The public entry points are autograd Functions. A tensor on the CPU
takes the plain PyTorch version (``dslash_reference``,
``hop_packed_reference``: rolls and einsums as in
latticeqcd_tpu/ops/dirac/wilson.py, the half-spinor form at r = 1 and
the projector form (r -+ g_mu) at any other r); a tensor on a CUDA
device launches the kernel, or the wrapper raises. The packed hop also takes a leading
chain axis of independent lattices (spinor [n, X/2, Y, Z, T, 4, 3],
links [n, 4, X/2, Y, Z, T, 3, 3], HMC.step_batched): one launch for all
n chains on the card, and on the CPU the plain version mapped over the
chains with torch.func.vmap. The backward with respect to the
spinor is the kernel again at the same r (the adjoint hop is gamma5 H
gamma5 with the link roles swapped, since gamma5 (r - g_mu) gamma5 =
r + g_mu); the backward with respect to the links is written with tensor
ops: outer products of the projected half spinors with the incoming
gradient, summed over spin (at r != 1, of the spinors with the
incoming gradient times (r -+ g_mu)).

Under a process grid (parallel/mesh.py) the fields are this rank's
blocks and the packed hop runs in its halo mode (``hop_packed_halo``):
before each hop the source field's boundary slabs are exchanged with the
neighbours (two messages per cut axis), and the kernel, or on the CPU
its plain version ``hop_packed_halo_reference``, reads the neighbours
outside the block from these face buffers. The backward links' faces
(the -mu neighbour's last slab of u_s[mu]) are exchanged once per link
tensor and kept while it lives and is not changed in place. The
backward reuses the forward's faces for the link gradient and exchanges
one slab more per cut axis to move the gradient of each backward link
onto the rank that holds it. ``halo_launches`` counts the halo mode's
launches at any r, ``r_halo_launches`` those of its r mode.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch
from torch.autograd.function import once_differentiable

from latticeqcd_torch import _nvcc
from latticeqcd_torch.ops import rolls
from latticeqcd_torch.ops.dirac import eo_pack, gammas
from latticeqcd_torch.parallel import mesh

DIRS = 4
launches = 0
halo_launches = 0
r_launches = 0
r_halo_launches = 0
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


@functools.lru_cache(maxsize=None)
def _projectors(r, dtype, device):
    pm, pp = gammas.projectors(r)
    return (torch.as_tensor(pm, dtype=dtype, device=device),
            torch.as_tensor(pp, dtype=dtype, device=device))


def _hop(u_fwd, u_bwd, psi, gplus, gminus, glink=None, r=1.0):
    """sum_mu (r - g_mu) U_fwd(x) psi(x+mu) + (r + g_mu) U_bwd(x-mu)^dag psi(x-mu),
    with the neighbour gathers given; ``glink`` gathers the backward links
    (``gminus`` unless given). At r = 1 the half-spinor form
    sum_mu 2 Vm[mu] U_fwd(x) (Vm^dag psi)(x+mu) + 2 Vp[mu] U_bwd(x-mu)^dag (Vp^dag psi)(x-mu),
    else the projector form (the JAX package's generic hop)."""
    glink = gminus if glink is None else glink
    if r != 1.0:
        pm, pp = _projectors(float(r), psi.dtype, psi.device)
        hop = 0.0
        for mu in range(DIRS):
            fwd = torch.einsum("...ab,...sb->...sa", u_fwd[mu], gplus(psi, mu))
            bwd = torch.einsum("...ba,...sb->...sa", glink(u_bwd[mu], mu).conj(), gminus(psi, mu))
            hop = hop + torch.einsum("st,...tc->...sc", pm[mu], fwd)
            hop = hop + torch.einsum("st,...tc->...sc", pp[mu], bwd)
        return hop
    vm, vp = _half_factors(psi.dtype, psi.device)
    hop = 0.0
    for mu in range(DIRS):
        half = torch.einsum("sh,...sc->...hc", vm[mu].conj(), gplus(psi, mu))
        half = torch.einsum("...ab,...hb->...ha", u_fwd[mu], half)
        hop = hop + 2.0 * torch.einsum("sh,...hc->...sc", vm[mu], half)
        half = torch.einsum("sh,...sc->...hc", vp[mu].conj(), gminus(psi, mu))
        half = torch.einsum("...ba,...hb->...ha", glink(u_bwd[mu], mu).conj(), half)
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


def hop_full_reference(u, psi, r=1.0):
    """Plain full-volume H psi at Wilson r."""
    return _hop(u, u, psi, full_plus, full_minus, r=r)


def dslash_reference(u, psi, kappa, r=1.0):
    """Plain full-volume D psi = psi - kappa H psi at Wilson r, per chain over a leading
    chain axis."""
    if psi.ndim == 7:
        return torch.func.vmap(lambda a, b: dslash_reference(a, b, kappa, r))(u, psi)
    return psi - kappa * hop_full_reference(u, psi, r)


def hop_packed_reference(u_t, u_s, psi_s, target_parity: int, r=1.0):
    """Plain H psi_s on target-parity sites (packed layout) at Wilson r, per chain
    over a leading chain axis."""
    if psi_s.ndim == 7:
        return torch.func.vmap(
            lambda a, b, c: hop_packed_reference(a, b, c, target_parity, r))(u_t, u_s, psi_s)
    gplus, gminus, _ = packed_gathers(psi_s, target_parity)
    return _hop(u_t, u_s, psi_s, gplus, gminus, r=r)


def _shift(f, mu, step, face):
    """f(x - step mu) on a block (step +-1): torch.roll along an axis the grid does
    not cut (face None), else the block's own slabs and the neighbour's face."""
    if face is None:
        return torch.roll(f, step, mu)
    n = f.shape[mu]
    if step < 0:
        return torch.cat([f.narrow(mu, 1, n - 1), face.unsqueeze(mu)], dim=mu)
    return torch.cat([face.unsqueeze(mu), f.narrow(mu, 0, n - 1)], dim=mu)


def halo_gathers(psi_s, target_parity, faces, link_faces):
    """(gather_plus, gather_minus, gather_link) of the packed layout on a block of a
    process grid, reading the neighbours outside the block from ``faces`` {mu: (lo,
    hi)} and, for the backward links, ``link_faces`` {mu: face}."""
    lattice = (2 * psi_s.shape[0],) + tuple(psi_s.shape[1:4])
    s_t = eo_pack.offset_field(lattice, target_parity)

    def plus(f, mu):
        moved = _shift(f, mu, -1, faces[mu][1] if mu in faces else None)
        return torch.where(eo_pack._mask(s_t, f.ndim - 4, f.device), moved, f) if mu == 0 else moved

    def minus_with(face_of):
        def minus(f, mu):
            moved = _shift(f, mu, 1, face_of(mu))
            return torch.where(eo_pack._mask(s_t, f.ndim - 4, f.device), f, moved) if mu == 0 else moved
        return minus

    return (plus, minus_with(lambda mu: faces[mu][0] if mu in faces else None),
            minus_with(link_faces.get))


def hop_packed_halo_reference(u_t, u_s, psi_s, target_parity: int, faces, link_faces, r=1.0):
    """Plain H psi_s on a block of a process grid (packed layout) at Wilson r, the
    neighbours outside the block from the face buffers."""
    return _hop(u_t, u_s, psi_s, *halo_gathers(psi_s, target_parity, faces, link_faces), r=r)


def dslash_halo_reference(u, psi, kappa, faces, link_faces, r=1.0):
    """Plain full-volume D psi = psi - kappa H psi at Wilson r on a block of a process grid,
    the neighbours outside the block from ``faces`` {mu: (lo, hi)} and the backward
    links' from ``link_faces`` {mu: face}."""
    def plus(f, mu):
        return _shift(f, mu, -1, faces[mu][1] if mu in faces else None)

    def minus(f, mu):
        return _shift(f, mu, 1, faces[mu][0] if mu in faces else None)

    def link(f, mu):
        return _shift(f, mu, 1, link_faces.get(mu))

    return psi - kappa * _hop(u, u, psi, plus, minus, link, r)


def _link_grads(g, psi, gplus, gminus, r=1.0):
    """Gradients of Re<g, H psi> (PyTorch's convention for a real loss of
    complex inputs) w.r.t. the forward links U_fwd(x) and the backward
    links U_bwd(x - mu), the latter still held at the target site x. At
    r = 1 from the half spinors (r -+ g_mu = 2 V V^dag), else from the
    full spinors: sum_s ((r - g_mu)^dag g)_s psi(x+mu)_s^dag forward and
    sum_s psi(x-mu)_s ((r + g_mu)^dag g)_s^dag backward."""
    fwd, bwd = [], []
    if r != 1.0:
        pm, pp = _projectors(float(r), psi.dtype, psi.device)
        for mu in range(DIRS):
            gp = torch.einsum("st,...sc->...tc", pm[mu].conj(), g)
            fwd.append(torch.einsum("...ti,...tj->...ij", gp, gplus(psi, mu).conj()))
            gp = torch.einsum("st,...sc->...tc", pp[mu].conj(), g)
            bwd.append(torch.einsum("...ti,...tj->...ij", gminus(psi, mu), gp.conj()))
        return fwd, bwd
    vm, vp = _half_factors(psi.dtype, psi.device)
    for mu in range(DIRS):
        gh = torch.einsum("sh,...sc->...hc", vm[mu].conj(), g)
        ph = torch.einsum("sh,...sc->...hc", vm[mu].conj(), gplus(psi, mu))
        fwd.append(2.0 * torch.einsum("...hi,...hj->...ij", gh, ph.conj()))
        gh = torch.einsum("sh,...sc->...hc", vp[mu].conj(), g)
        ph = torch.einsum("sh,...sc->...hc", vp[mu].conj(), gminus(psi, mu))
        bwd.append(2.0 * torch.einsum("...hi,...hj->...ij", ph, gh.conj()))
    return fwd, bwd


def _full_link_grads(g, psi, r=1.0):
    """d u of Re<g, H psi> at Wilson r on the full lattice, per chain over a leading chain
    axis. The gathers are rolls.roll, which on a block of a process grid exchange the slabs
    that cross its faces."""
    if psi.ndim == 7:
        return torch.func.vmap(lambda a, b: _full_link_grads(a, b, r))(g, psi)
    fwd, bwd = _link_grads(g, psi, full_plus, full_minus, r)
    return torch.stack([fwd[mu] + rolls.roll(bwd[mu], -1, mu) for mu in range(DIRS)])


def _packed_link_grads(g, psi_s, target_parity, r=1.0):
    """(d u_t, d u_s) of Re<g, H psi_s> at Wilson r on the packed layout, per chain
    over a leading chain axis."""
    if psi_s.ndim == 7:
        return torch.func.vmap(
            lambda a, b: _packed_link_grads(a, b, target_parity, r))(g, psi_s)
    gplus, gminus, scatter = packed_gathers(psi_s, target_parity)
    fwd, bwd = _link_grads(g, psi_s, gplus, gminus, r)
    return torch.stack(fwd), torch.stack([scatter(bwd[mu], mu) for mu in range(DIRS)])


# ----------------------------------------------------------------- the kernel


_VP, _CI, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_CD = ctypes.c_double
_PACKED_ARGS = [_VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _CI, _VP]
_BRICK_ARGS = _PACKED_ARGS[:-1] + [_CI, _LL, _LL, _VP]
_HALO_ARGS = _PACKED_ARGS[:-1] + [_CI, _VP, _VP]
# csrc/<name>.cu -> its C entry points (each with a _c64 and a _c128 form) and their arguments
_ENTRY_POINTS = {
    "wilson_hop": {"wilson_hop_full": [_VP, _VP, _VP, _CI, _CI, _CI, _CI, _CD, _VP],
                   "wilson_hop_packed": _PACKED_ARGS},
    # the packed mode's arguments, then the chain count and the links' and spinors' chain
    # strides; the halo mode's, then the partition mask and the array of 12 face pointers;
    # the r mode's (_r) those, then the Wilson r
    "wilson_hop_packed": {"wilson_hop_brick": _BRICK_ARGS, "wilson_hop_halo": _HALO_ARGS,
                          "wilson_hop_brick_r": _BRICK_ARGS + [_CD],
                          "wilson_hop_halo_r": _HALO_ARGS + [_CD]},
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


# the grid's y extent, which holds the chains
MAX_CHAINS = 65535


def _check(psi, *links, kernel="wilson_hop", chains=False):
    """Raise on anything the kernel (any of the Wilson kernels) does not take;
    with ``chains`` a leading chain axis is allowed."""
    if psi.device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got {psi.device}")
    if psi.dtype not in _SUFFIX:
        raise TypeError(f"{kernel} takes complex64 or complex128, got {psi.dtype}")
    lead = psi.ndim - 6
    if lead not in ((0, 1) if chains else (0,)) or tuple(psi.shape[-2:]) != (4, 3):
        raise ValueError(f"spinor must be [{'(n,) ' if chains else ''}X,Y,Z,T,4,3], "
                         f"got {tuple(psi.shape)}")
    if lead and not 1 <= psi.shape[0] <= MAX_CHAINS:
        raise ValueError(f"{kernel} takes 1 to {MAX_CHAINS} chains, got {psi.shape[0]}")
    want = tuple(psi.shape[:lead]) + (DIRS,) + tuple(psi.shape[lead:lead + 4]) + (3, 3)
    vol = psi.shape[lead] * psi.shape[lead + 1] * psi.shape[lead + 2] * psi.shape[lead + 3]
    if vol == 0 or 36 * vol >= 2**31:
        raise ValueError(f"lattice volume {vol} outside the kernel's 32-bit indexing")
    for t in (psi,) + links:
        if t.device != psi.device or t.dtype != psi.dtype:
            raise TypeError(f"{kernel} fields must share device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} fields must be contiguous")
    if psi.data_ptr() % 16:  # the bulk copies of wilson_hop_packed and wilson_window
        raise ValueError(f"{kernel} needs a 16-byte aligned spinor")
    for u in links:
        if tuple(u.shape) != want:
            raise ValueError(f"links must be {want}, got {tuple(u.shape)}")


def _raise_on_error(err: int, lib: str, entry: str):
    if err != 0:
        raise RuntimeError(f"{lib} {entry} launch failed: CUDA error {err}")


def _dslash(u, psi, kappa, r=1.0):
    if psi.device.type == "cpu":
        return dslash_reference(u, psi, kappa, r)
    if r != 1.0:
        raise ValueError(f"wilson_hop's full mode holds r = 1, got r = {r}")
    _check(psi, u)
    out = torch.empty_like(psi)
    fn = _fn("wilson_hop", "wilson_hop_full", psi.dtype)
    with torch.cuda.device(psi.device):
        err = fn(u.data_ptr(), psi.data_ptr(), out.data_ptr(), *psi.shape[:4], float(kappa),
                 torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, "wilson_hop", "wilson_hop_full")
    site_launches["full"] += 1
    return out


def _packed(lib, entry, u_t, u_s, psi_s, target_parity, chains=(), r_arg=()):
    """Launch the packed-hop entry point `entry` of csrc/<lib>.cu; ``chains`` are
    the chain arguments of an entry point that takes them, ``r_arg`` the r mode's r,
    after the stream."""
    out = torch.empty_like(psi_s)
    fn = _fn(lib, entry, psi_s.dtype)
    with torch.cuda.device(psi_s.device):
        err = fn(u_t.data_ptr(), u_s.data_ptr(), psi_s.data_ptr(), out.data_ptr(),
                 *psi_s.shape[-6:-2], int(target_parity), *chains,
                 torch.cuda.current_stream().cuda_stream, *r_arg)
    _raise_on_error(err, lib, entry)
    return out


def chain_args(psi, u, site_ndim: int):
    """(n, the links' chain stride, the field's chain stride) in elements, for a
    field whose sites carry ``site_ndim`` axes and may lead with a chain axis;
    one chain has strides 0."""
    if psi.ndim == 4 + site_ndim:
        return 1, 0, 0
    return psi.shape[0], u[0].numel(), psi[0].numel()


def _r_mode(entry, r):
    """(the entry point, its r argument) at Wilson r: the r mode's ``_r`` entry point
    and (r,), or at r = 1 the half-spinor one and ()."""
    return (entry, ()) if r == 1.0 else (f"{entry}_r", (float(r),))


def _hop_packed(u_t, u_s, psi_s, target_parity, r=1.0):
    """The packed hop on the paths: the wilson_hop_packed kernel (its r mode at
    r != 1), one launch for all chains of a leading chain axis."""
    global launches, r_launches
    if psi_s.device.type == "cpu":
        return hop_packed_reference(u_t, u_s, psi_s, target_parity, r)
    _check(psi_s, u_t, u_s, kernel="wilson_hop_packed", chains=True)
    # the kernel's bulk copies read 16-byte aligned rows; every chain's rows are then aligned
    # too (a chain's spinors are a multiple of 96 bytes)
    if psi_s.data_ptr() % 16:
        psi_s = psi_s.clone()
    entry, r_arg = _r_mode("wilson_hop_brick", r)
    out = _packed("wilson_hop_packed", entry, u_t, u_s, psi_s, target_parity,
                  chain_args(psi_s, u_t, 2), r_arg)
    launches += 1
    r_launches += r != 1.0
    return out


def _check_faces(psi_s, u_s, faces, link_faces):
    for mu, (lo, hi) in faces.items():
        want = tuple(psi_s.shape[:mu]) + tuple(psi_s.shape[mu + 1:])
        lwant = tuple(u_s.shape[1:1 + mu]) + tuple(u_s.shape[2 + mu:])
        for face, shape in ((lo, want), (hi, want), (link_faces[mu], lwant)):
            if tuple(face.shape) != shape or face.dtype != psi_s.dtype or face.device != psi_s.device:
                raise ValueError(f"a face along {mu} must be {shape} {psi_s.dtype} on "
                                 f"{psi_s.device}, got {tuple(face.shape)} {face.dtype} {face.device}")
            if not face.is_contiguous() or face.data_ptr() % 16:
                raise ValueError("the halo mode's faces must be contiguous and 16-byte aligned")


def hop_packed_halo(u_t, u_s, psi_s, target_parity: int, faces, link_faces, r=1.0):
    """H psi_s at Wilson r on this rank's block of a process grid: ``faces`` {mu: (lo,
    hi)} holds, for each cut axis mu, the -mu neighbour's last and the +mu neighbour's
    first slab of psi_s with axis mu removed, ``link_faces`` {mu: the -mu neighbour's last
    slab of u_s[mu]}. The kernel's halo mode on CUDA (one launch; its r mode at r != 1),
    the plain version on the CPU."""
    global halo_launches, r_halo_launches
    if psi_s.device.type == "cpu":
        return hop_packed_halo_reference(u_t, u_s, psi_s, target_parity, faces, link_faces, r)
    _check(psi_s, u_t, u_s, kernel="wilson_hop_packed")
    _check_faces(psi_s, u_s, faces, link_faces)
    ptrs = [None] * 12
    for mu, (lo, hi) in faces.items():
        ptrs[mu], ptrs[4 + mu], ptrs[8 + mu] = lo.data_ptr(), hi.data_ptr(), link_faces[mu].data_ptr()
    out = torch.empty_like(psi_s)
    entry, r_arg = _r_mode("wilson_hop_halo", r)
    fn = _fn("wilson_hop_packed", entry, psi_s.dtype)
    with torch.cuda.device(psi_s.device):
        err = fn(u_t.data_ptr(), u_s.data_ptr(), psi_s.data_ptr(), out.data_ptr(),
                 *psi_s.shape[:4], int(target_parity), sum(1 << mu for mu in faces),
                 (ctypes.c_void_p * 12)(*ptrs), torch.cuda.current_stream().cuda_stream, *r_arg)
    _raise_on_error(err, "wilson_hop_packed", entry)
    halo_launches += 1
    r_halo_launches += r != 1.0
    return out


_LINK_FACES: dict = {}


def link_faces(u_s, grid):
    """{mu: the -mu neighbour's last slab of u_s[mu]} for each cut axis: exchanged once
    per link tensor and kept while it lives and is not changed in place."""
    hit = _LINK_FACES.get(id(u_s))
    if hit is not None and hit[0]() is u_s and hit[1] == u_s._version:
        return hit[2]
    faces = mesh.pass_slabs({mu: u_s[mu].select(mu, u_s.shape[1 + mu] - 1)
                             for mu in grid.partitioned}, +1, grid)
    key = id(u_s)
    _LINK_FACES[key] = (weakref.ref(u_s, lambda _, k=key: _LINK_FACES.pop(k, None)),
                        u_s._version, faces)
    return faces


def _grid_hop(u_t, u_s, psi_s, target_parity, grid, r=1.0):
    """(H psi_s at Wilson r, the faces of psi_s) on a block of ``grid``: the faces
    exchanged, then the halo mode."""
    if psi_s.ndim != 6:
        raise NotImplementedError("a chain axis under a process grid is not ported yet "
                                  "(ROADMAP A14b)")
    faces = mesh.exchange_faces(psi_s, grid)
    return (hop_packed_halo(u_t, u_s, psi_s, target_parity, faces, link_faces(u_s, grid), r),
            faces)


def split_backward(bwd, psi_s, target_parity):
    """The gradients of the backward links of a packed hop, held at the target sites x
    (one per mu), split into the part that moves to x - mu (``moving[mu]``) and the part
    that stays (``staying``, x only: the sites whose gather did not move)."""
    lattice = (2 * psi_s.shape[0],) + tuple(psi_s.shape[1:4])
    b = eo_pack._mask(eo_pack.offset_field(lattice, target_parity), bwd[0].ndim - 4,
                      bwd[0].device)
    zero = torch.zeros_like(bwd[0])
    return [torch.where(b, zero, bwd[0])] + list(bwd[1:]), torch.where(b, bwd[0], zero)


def halo_link_grads(g, psi_s, target_parity, faces, r=1.0):
    """The link gradients of Re<g, H psi_s> at Wilson r on a block, from the faces of
    psi_s: (d u_t, moving, staying), the gradients of the backward links split by
    ``split_backward``."""
    gplus, gminus, _ = halo_gathers(psi_s, target_parity, faces, {})
    fwd, bwd = _link_grads(g, psi_s, gplus, gminus, r)
    return (torch.stack(fwd),) + tuple(split_backward(bwd, psi_s, target_parity))


def scatter_halo(moving, staying, heads):
    """d u_s from halo_link_grads' parts: moving[mu] shifted to x - mu, its slab past the
    block's end from ``heads`` {mu: the +mu neighbour's first slab of moving[mu]} (an
    axis without a head wraps), plus the part that stays."""
    d_us = [_shift(moving[mu], mu, -1, heads.get(mu)) for mu in range(DIRS)]
    d_us[0] = d_us[0] + staying
    return torch.stack(d_us)


def scatter_across_faces(moving, staying, grid):
    """d u_s on a block of ``grid`` from split_backward's parts: the heads of ``moving``
    come from the +mu neighbours, one slab per cut axis."""
    heads = mesh.pass_slabs({mu: moving[mu].select(mu, 0) for mu in grid.partitioned}, -1, grid)
    return scatter_halo(moving, staying, heads)


def _grid_link_grads(g, psi_s, target_parity, faces, grid, r=1.0):
    """(d u_t, d u_s) of Re<g, H psi_s> at Wilson r on a block, from the forward's faces;
    the gradients of the backward links move across the block's faces by one more slab
    per cut axis."""
    d_ut, moving, staying = halo_link_grads(g, psi_s, target_parity, faces, r)
    return d_ut, scatter_across_faces(moving, staying, grid)


def hop_packed_site(u_t, u_s, psi_s, target_parity: int):
    """The same packed hop (r = 1) through wilson_hop's one-thread-per-site packed
    mode (forward only), kept as the yardstick of wilson_hop_packed."""
    if psi_s.device.type == "cpu":
        return hop_packed_reference(u_t, u_s, psi_s, target_parity)
    _check(psi_s, u_t, u_s)
    out = _packed("wilson_hop", "wilson_hop_packed", u_t, u_s, psi_s, target_parity)
    site_launches["packed"] += 1
    return out


# ------------------------------------------------------------------- autograd


class WilsonDslash(torch.autograd.Function):
    """D psi = psi - kappa H psi (full volume) at Wilson r through ``dslash``, the
    launch of a full-D kernel (this module's full mode, or wilson_window's, which
    under a process grid runs its halo mode and takes a leading chain axis
    otherwise); the spinor gradient runs ``dslash`` again, the link gradient is
    ``_full_link_grads``."""

    @staticmethod
    def forward(ctx, u, psi, kappa, dslash, r):
        ctx.save_for_backward(u, psi)
        ctx.kappa, ctx.dslash, ctx.r = kappa, dslash, r
        return dslash(u, psi, kappa, r)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        u, psi = ctx.saved_tensors
        g = g.contiguous()
        d_u = d_psi = None
        if ctx.needs_input_grad[1]:
            d_psi = gamma5(ctx.dslash(u, gamma5(g), ctx.kappa, ctx.r))  # D^dag = g5 D g5
        if ctx.needs_input_grad[0]:
            d_u = -ctx.kappa * _full_link_grads(g, psi, ctx.r)
        return d_u, d_psi, None, None, None


class WilsonHopPacked(torch.autograd.Function):
    """H psi_s on target-parity sites (packed even-odd layout) at Wilson r, with or
    without a leading chain axis."""

    @staticmethod
    def forward(ctx, u_t, u_s, psi_s, target_parity, r):
        ctx.save_for_backward(u_t, u_s, psi_s)
        ctx.parity, ctx.r = target_parity, r
        ctx.grid = mesh.sharded()
        if ctx.grid is None:
            return _hop_packed(u_t, u_s, psi_s, target_parity, r)
        out, ctx.faces = _grid_hop(u_t, u_s, psi_s, target_parity, ctx.grid, r)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        u_t, u_s, psi_s = ctx.saved_tensors
        g = g.contiguous()
        grid = ctx.grid
        d_ut = d_us = d_psi = None
        if ctx.needs_input_grad[2]:
            # H_ts^dag = g5 H_st g5 at the same r: the source parity becomes the target,
            # u_s supplies the forward links and u_t the backward ones
            if grid is None:
                d_psi = gamma5(_hop_packed(u_s, u_t, gamma5(g), 1 - ctx.parity, ctx.r))
            else:
                d_psi = gamma5(_grid_hop(u_s, u_t, gamma5(g), 1 - ctx.parity, grid, ctx.r)[0])
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            if grid is None:
                d_ut, d_us = _packed_link_grads(g, psi_s, ctx.parity, ctx.r)
            else:
                d_ut, d_us = _grid_link_grads(g, psi_s, ctx.parity, ctx.faces, grid, ctx.r)
        return d_ut, d_us, d_psi, None, None


def wilson_dslash(u, psi, kappa):
    """Full D psi (r = 1) through the kernel on CUDA, the plain version on the CPU.
    wilson_hop's full mode has no halo mode: it raises under a process grid."""
    mesh.refuse_under_grid("wilson_hop's full mode")
    return WilsonDslash.apply(u, psi, float(kappa), _dslash, 1.0)


def wilson_hop_packed(u_t, u_s, psi_s, target_parity: int, r: float = 1.0):
    """Packed H psi_s at Wilson r through the kernel on CUDA (its r mode at r != 1),
    the plain version on the CPU."""
    return WilsonHopPacked.apply(u_t, u_s, psi_s, int(target_parity), float(r))
