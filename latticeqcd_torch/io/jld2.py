"""JLD2 (HDF5) gauge-configuration I/O through h5py.

Counterpart of latticeqcd_tpu/io/jld2.py. JLD2 files are HDF5 files.
Gaugefields.jl serialises a ``Vector{<:Gaugefields_4D}`` of Julia
structs, which JLD2 encodes as HDF5 compound data and object
references, with Julia's column-major axis order reversed in h5py's
row-major view and, for the wing variants, halo cells in the stored
array.

The loader walks the whole HDF5 tree, follows references and compound
members, turns JLD2's complex encoding (compound ``re``/``im`` members)
into numpy complex, and keeps every array that could be one direction's
links for the requested lattice: h5py shape ``(T', Z', Y', X', nc, nc)``
where each primed extent is the lattice extent, or that plus 2*Nwing
for one wing width. Wings are stripped, the axes transposed to
``U[mu, x, y, z, t, a, b]`` and the colour matrix transposed. Four
per-direction arrays, or one 7-axis array with a leading or trailing
direction axis, are accepted; a file without them raises an error
naming the shapes it holds.

h5py is optional: without it every call raises an ImportError that
says so and names the formats that need nothing more.
"""

from __future__ import annotations

import numpy as np
import torch

from latticeqcd_torch.io.native import host_array, to_links

try:
    import h5py

    _H5PY_ERR = None
except Exception as _e:  # noqa: BLE001
    h5py = None
    _H5PY_ERR = _e

DIRS = 4
_MAX_WING = 4


def _require_h5py():
    if h5py is None:
        raise ImportError(
            "JLD2 I/O needs h5py, which failed to import "
            f"({_H5PY_ERR}); convert the .jld2 file to ILDG/Bridge text, "
            "or install h5py"
        )


def _to_complex(arr: np.ndarray):
    """Map JLD2 value encodings to a plain numpy array (complex where possible)."""
    if arr.dtype.kind == "c":
        return arr
    if arr.dtype.kind == "f":
        return arr
    if arr.dtype.names:
        names = set(arr.dtype.names)
        for re_k, im_k in (("re", "im"), ("r", "i"), ("real", "imag")):
            if {re_k, im_k} <= names:
                return arr[re_k].astype(np.float64) + 1j * arr[im_k].astype(np.float64)
    return None


def _harvest(node, fp, out, depth=0):
    """Recursively collect candidate numeric arrays from an HDF5 node."""
    if depth > 6:
        return
    if isinstance(node, h5py.Group):
        for key in node:
            if key.startswith("_"):  # JLD2 metadata: _types etc.
                continue
            try:
                _harvest(node[key], fp, out, depth + 1)
            except Exception:  # noqa: BLE001 - skip unreadable members
                continue
        return
    if not isinstance(node, h5py.Dataset):
        return
    try:
        raw = node[()]
    except Exception:  # noqa: BLE001
        return
    _harvest_value(raw, fp, out, depth)


def _harvest_value(raw, fp, out, depth):
    if depth > 8:
        return
    if isinstance(raw, h5py.Reference):
        if raw:
            _harvest(fp[raw], fp, out, depth + 1)
        return
    if isinstance(raw, np.void):  # 0-d compound scalar (a Julia struct)
        raw = np.asarray(raw)
    if not isinstance(raw, np.ndarray):
        return
    if raw.dtype.kind == "O" or raw.dtype == h5py.ref_dtype:
        for item in raw.reshape(-1):
            _harvest_value(item, fp, out, depth + 1)
        return
    if raw.dtype.names:
        cplx = _to_complex(raw)
        if cplx is not None:
            out.append(cplx)
            return
        # Julia struct as compound: recurse into each member (the link
        # array is typically a reference member named "U").
        for name in raw.dtype.names:
            _harvest_value(raw[name], fp, out, depth + 1)
        return
    if raw.dtype.kind in "cf":
        out.append(raw)


def _as_direction(arr: np.ndarray, lattice, nc: int):
    """Try to view one harvested array as a single direction's links.

    Returns U[x, y, z, t, a, b] or None. ``arr`` has h5py (row-major
    reversed) axis order, i.e. Julia (a, b, x, y, z, t) arrives as
    (t, z, y, x, b, a).
    """
    nx, ny, nz, nt = lattice
    if arr.ndim != 6 or arr.shape[-1] != nc or arr.shape[-2] != nc:
        return None
    rev = (nt, nz, ny, nx)
    for w in range(_MAX_WING + 1):
        if arr.shape[:4] == tuple(d + 2 * w for d in rev):
            core = arr[w : arr.shape[0] - w or None, w : arr.shape[1] - w or None,
                       w : arr.shape[2] - w or None, w : arr.shape[3] - w or None]
            if w:
                core = core[:nt, :nz, :ny, :nx]
            # (t,z,y,x,b,a) -> (x,y,z,t,a,b): reverse lattice axes, swap color
            return np.transpose(core, (3, 2, 1, 0, 5, 4))
    return None


def load_jld2(filename, lattice, nc: int, dtype=torch.complex128,
              device="cuda") -> torch.Tensor:
    """Load U[mu, x, y, z, t, a, b] from a JLD2/HDF5 file onto ``device``."""
    _require_h5py()
    harvested: list = []
    with h5py.File(filename, "r") as fp:
        _harvest(fp, fp, harvested)
    dirs = []
    shapes_seen = []
    for arr in harvested:
        shapes_seen.append(tuple(arr.shape))
        if arr.ndim == 7:
            # single stacked array; direction axis leading (h5py view of
            # Julia (a,b,x,y,z,t,mu)) or trailing
            for ax in (0, 6):
                if arr.shape[ax] == DIRS:
                    sub = np.moveaxis(arr, ax, 0)
                    got = [_as_direction(sub[m], lattice, nc) for m in range(DIRS)]
                    if all(g is not None for g in got):
                        dirs = got
                        break
            if len(dirs) == DIRS:
                break
        d = _as_direction(arr, lattice, nc)
        if d is not None:
            dirs.append(d)
            if len(dirs) == DIRS:
                break
    if len(dirs) != DIRS:
        raise ValueError(
            f"{filename}: could not find {DIRS} SU({nc}) link arrays for "
            f"lattice {tuple(lattice)} in the JLD2 file (found {len(dirs)}; "
            f"array shapes present: {sorted(set(shapes_seen))})"
        )
    return to_links(np.stack(dirs, axis=0), dtype, device)


def save_jld2(filename, u) -> None:
    """Save U[mu, x, y, z, t, a, b] as a JLD2-compatible HDF5 file.

    The layout is what Gaugefields.jl's saveU writes for the nowing
    field type as seen through h5py: a group ``U`` with one dataset per
    direction, each the Julia column-major array ``(nc, nc, NX, NY, NZ,
    NT)`` (h5py shape reversed) of complex numbers as a compound
    ``re``/``im`` float64 type.
    """
    _require_h5py()
    un = host_array(u)
    cdt = np.dtype([("re", "<f8"), ("im", "<f8")])
    with h5py.File(filename, "w") as fp:
        grp = fp.create_group("U")
        for mu in range(un.shape[0]):
            # (x,y,z,t,a,b) -> h5py (t,z,y,x,b,a) = Julia (a,b,x,y,z,t)
            jarr = np.transpose(un[mu], (3, 2, 1, 0, 5, 4))
            buf = np.empty(jarr.shape, dtype=cdt)
            buf["re"] = jarr.real
            buf["im"] = jarr.imag
            grp.create_dataset(str(mu + 1), data=buf)
