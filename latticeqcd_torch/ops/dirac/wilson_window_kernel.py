"""wilson_window: the hand-written CUDA full Wilson D with each field read once.

Replaces the Pallas kernel dslash_planes_window of
latticeqcd_tpu/ops/dirac/wilson_pallas.py (see csrc/wilson_window.cu for
the design and what bounds it: three lanes per site, blocks of whole
(y, z) rows marching along x with their spinor rows staged by bulk
copies): D psi = psi - kappa H psi on the full lattice [X,Y,Z,T,4,NC],
csw = 0, boundary phases already in the links, at r = 1 in the
half-spinor form and at any other Wilson r in the kernel's r mode (the
``_r`` entry points, (r -+ g_mu) applied in full). It is what
``WilsonDirac.apply`` runs: the Wilson Dirac spectrum (Lanczos on D^dag
D), the full-volume CGNE of the fermionic measurements on lattices with
an odd extent, clover HMC, domain wall's D_w4 and the dense log det.

``wilson_window`` goes through ``wilson_kernel.WilsonDslash``, the
autograd Function of the full D, with this module's launch: the spinor
gradient is gamma5 D gamma5 through this kernel, the link gradient the
outer products of ``wilson_kernel._link_grads``, at the same r. A tensor
on the CPU takes the plain version (``wilson_kernel.dslash_reference``);
a tensor on a CUDA device launches the kernel, or the wrapper raises.

A leading chain axis of independent lattices (spinor [n, X, Y, Z, T, 4,
3], links [n, 4, X, Y, Z, T, 3, 3], HMC.step_batched) is one launch of
the kernel's chains entry points for all n chains, forward and spinor
backward alike (one chain: the kernel without the chain offsets); the
link gradient and the plain version are mapped over the chains with
torch.func.vmap.

Under a process grid (parallel/mesh.py) the fields are this rank's
blocks and every D runs the kernel's halo mode (``dslash_halo``): the
spinor's boundary slabs are exchanged with the neighbours first (two
messages per cut axis), the backward links' faces once per link tensor
(wilson_kernel.link_faces), and the kernel, or on the CPU its plain
version ``wilson_kernel.dslash_halo_reference``, reads the neighbours
outside the block from these face buffers. A leading chain axis there
(HMC.step_batched on a grid) runs the chain-halo mode (the
``wilson_window_halo_chains`` entry points): every chain's faces in one
message per direction and cut axis, one launch for all chains.

``launches`` counts kernel launches outside the halo mode (forward and
backward alike, at any r, with or without a chain axis), ``halo_launches``
those of the halo mode; ``r_launches`` and ``r_halo_launches`` count those
of the r mode among them, ``chain_launches`` those with a chain axis
outside the halo mode and ``chain_halo_launches`` those in it.
"""

from __future__ import annotations

import ctypes

import torch

from latticeqcd_torch import _nvcc
from latticeqcd_torch.ops.dirac import wilson_kernel
from latticeqcd_torch.parallel import mesh

launches = 0
halo_launches = 0
r_launches = 0
r_halo_launches = 0
chain_launches = 0
chain_halo_launches = 0

_SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _nvcc.load("wilson_window")
        vp, ci, ll, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
        chains = [vp, vp, vp, ci, ci, ci, ci, ci, ll, ll, cd]
        halo_chains = [vp, vp, vp, ci, ci, ci, ci, ci, ll, ll, vp, cd]
        # the r mode's entry points (_r) take the Wilson r after kappa; the chains entry points
        # the chain count and the links' and spinors' chain strides after the extents, the
        # chain-halo mode's also the array of the faces' chain strides
        for suffix in _SUFFIX.values():
            for entry, argtypes in (
                    ("wilson_window", [vp, vp, vp, ci, ci, ci, ci, cd, vp]),
                    ("wilson_window_halo", [vp, vp, vp, ci, ci, ci, ci, cd, ci, vp, vp]),
                    ("wilson_window_chains", chains + [vp]),
                    ("wilson_window_halo_chains", halo_chains + [ci, vp, vp]),
                    ("wilson_window_r", [vp, vp, vp, ci, ci, ci, ci, cd, cd, vp]),
                    ("wilson_window_halo_r", [vp, vp, vp, ci, ci, ci, ci, cd, cd, ci, vp, vp]),
                    ("wilson_window_chains_r", chains + [cd, vp]),
                    ("wilson_window_halo_chains_r", halo_chains + [cd, ci, vp, vp])):
                fn = getattr(lib, f"{entry}_{suffix}")
                fn.argtypes, fn.restype = argtypes, ci
        _LIB = lib
    return _LIB


def dslash_halo(u, psi, kappa, faces, link_faces, r=1.0):
    """D psi at Wilson r on this rank's block of a process grid: ``faces`` {mu: (lo, hi)}
    holds, for each cut axis mu, the -mu neighbour's last and the +mu neighbour's first
    slab of psi with axis mu removed, ``link_faces`` {mu: the -mu neighbour's last slab
    of u[mu]}. The kernel's halo mode on CUDA (one launch; its r mode at r != 1; with a
    leading chain axis, on fields and faces alike, its chain-halo mode, one launch for all
    chains), the plain version on the CPU."""
    global halo_launches, r_halo_launches, chain_halo_launches
    if psi.device.type == "cpu":
        return wilson_kernel.dslash_halo_reference(u, psi, kappa, faces, link_faces, r)
    chained = psi.ndim == 7
    wilson_kernel._check(psi, u, kernel="wilson_window", chains=chained)
    wilson_kernel._check_faces(psi, u, faces, link_faces)
    mask, ptrs, strides = wilson_kernel.face_args(faces, link_faces, chained)
    out = torch.empty_like(psi)
    entry, r_arg = wilson_kernel._r_mode(
        "wilson_window_halo_chains" if chained else "wilson_window_halo", r)
    chains = (*wilson_kernel.chain_args(psi, u, 2), strides) if chained else ()
    fn = getattr(_lib(), f"{entry}_{_SUFFIX[psi.dtype]}")
    with torch.cuda.device(psi.device):
        err = fn(u.data_ptr(), psi.data_ptr(), out.data_ptr(), *psi.shape[-6:-2], *chains,
                 float(kappa), *r_arg, mask, ptrs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    halo_launches += 1
    r_halo_launches += r != 1.0
    chain_halo_launches += chained
    return out


def _dslash(u, psi, kappa, r=1.0):
    global launches, r_launches, chain_launches
    grid = mesh.sharded()
    if grid is not None:
        return dslash_halo(u, psi, kappa, mesh.exchange_faces(psi, grid, lead=psi.ndim - 6),
                           wilson_kernel.link_faces(u, grid), r)
    if psi.device.type == "cpu":
        return wilson_kernel.dslash_reference(u, psi, kappa, r)
    wilson_kernel._check(psi, u, kernel="wilson_window", chains=True)
    out = torch.empty_like(psi)
    # a leading chain axis: the chains entry point, one launch for all chains
    chains = () if psi.ndim == 6 else wilson_kernel.chain_args(psi, u, 2)
    entry, r_arg = wilson_kernel._r_mode("wilson_window_chains" if chains else "wilson_window", r)
    fn = getattr(_lib(), f"{entry}_{_SUFFIX[psi.dtype]}")
    with torch.cuda.device(psi.device):
        err = fn(u.data_ptr(), psi.data_ptr(), out.data_ptr(), *psi.shape[-6:-2], *chains,
                 float(kappa), *r_arg, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    launches += 1
    r_launches += r != 1.0
    chain_launches += psi.ndim == 7
    return out


def wilson_window(u, psi, kappa, r=1.0):
    """Full D psi at Wilson r through the kernel on CUDA (its r mode at r != 1), the
    plain version on the CPU, with or without a leading chain axis (one launch for all
    chains); under a process grid the halo mode on this rank's block."""
    return wilson_kernel.WilsonDslash.apply(u, psi, float(kappa), _dslash, float(r))
