"""ILDG gauge-configuration I/O (LIME container, big-endian float64).

Counterpart of latticeqcd_tpu/io/ildg.py, writing the same bytes: a LIME
container (magic 0x456789ab, 144-byte record headers) holding an
``ildg-format`` XML record and an ``ildg-binary-data`` record with
big-endian float64 data ordered t-slowest/x-fastest, mu = x, y, z, t,
colour row-major, re/im interleaved (the Bridge++ text order). On load,
32-bit payloads (``<precision>32</precision>``), files holding several
configurations and plain headerless big-endian blobs are accepted too.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from latticeqcd_torch.io.native import host_array, to_links

DIRS = 4
LIME_MAGIC = 0x456789AB


def _scan_config_spans(fp, size: int):
    """Header-only LIME scan: list (precision, offset, nbytes) for every
    ildg-binary-data record, seeking over payloads (only the 144-byte
    headers and the small ildg-format XML records are read).

    One LIME file may hold several configurations, each its own message
    with an ildg-format record followed by ildg-binary-data. The precision
    from an ildg-format record applies to every later binary record until
    the next ildg-format (some writers share one header record across
    several configurations).
    """
    configs = []
    precision = 64
    pos = 0
    while pos + 144 <= size:
        fp.seek(pos)
        header = fp.read(144)
        magic, _version, _flags, datalength = struct.unpack_from(">IHHQ", header, 0)
        if magic != LIME_MAGIC:
            raise ValueError(f"bad LIME magic at offset {pos}: {magic:#x}")
        rectype = header[16:144].split(b"\x00", 1)[0].decode("ascii", "replace")
        start = pos + 144
        if rectype == "ildg-format":
            txt = fp.read(datalength).decode("ascii", "replace")
            precision = 32 if "<precision>32</precision>" in txt else 64
        elif rectype == "ildg-binary-data":
            configs.append((precision, start, datalength))
        pos = start + (datalength + 7) // 8 * 8
    return configs


class ILDG:
    """Indexable view of a (possibly multi-config) ILDG/LIME file:
    ``len(ildg)`` configurations, ``ildg.load(i, lattice, nc)`` with a
    1-based ``i`` as in LatticeQCD.jl. Only LIME headers are read at
    construction; ``load`` reads one payload."""

    def __init__(self, filename):
        self.filename = filename
        size = os.path.getsize(filename)
        with open(filename, "rb") as fp:
            head = fp.read(4)
            if len(head) >= 4 and struct.unpack(">I", head)[0] == LIME_MAGIC:
                self._configs = _scan_config_spans(fp, size)
                if not self._configs:
                    raise ValueError(f"{filename}: no ildg-binary-data record found")
            else:
                # headerless blob; precision inferred from size at load
                self._configs = [(None, 0, size)]

    def __len__(self) -> int:
        return len(self._configs)

    def load(self, i: int, lattice, nc: int, dtype=torch.complex128,
             device="cuda") -> torch.Tensor:
        """Load configuration ``i`` (1-based) onto ``device``."""
        if not 1 <= i <= len(self._configs):
            raise IndexError(
                f"{self.filename}: config index {i} out of range 1..{len(self._configs)}"
            )
        precision, offset, nbytes = self._configs[i - 1]
        with open(self.filename, "rb") as fp:
            fp.seek(offset)
            payload = fp.read(nbytes)
        return _decode_payload(payload, precision, lattice, nc, dtype, device, self.filename)


def load_ildg(filename, lattice, nc: int, dtype=torch.complex128, index: int = 1,
              device="cuda") -> torch.Tensor:
    """Load gauge field ``index`` (1-based) U[mu, x, y, z, t, a, b] from an ILDG file."""
    return ILDG(filename).load(index, lattice, nc, dtype=dtype, device=device)


def _decode_payload(payload, precision, lattice, nc, dtype, device, filename):
    nx, ny, nz, nt = lattice
    if precision is None:  # headerless blob: infer from byte count
        nbytes_f64 = nt * nz * ny * nx * DIRS * nc * nc * 2 * 8
        precision = 32 if len(payload) == nbytes_f64 // 2 else 64
    fdtype = ">f8" if precision == 64 else ">f4"
    data = np.frombuffer(payload, dtype=fdtype).astype(np.float64)
    expected = nt * nz * ny * nx * DIRS * nc * nc * 2
    if data.size != expected:
        raise ValueError(
            f"{filename}: {data.size} floats, expected {expected} for {lattice} NC={nc}"
        )
    cplx = data[0::2] + 1j * data[1::2]
    arr = cplx.reshape(nt, nz, ny, nx, DIRS, nc, nc)
    return to_links(np.transpose(arr, (4, 3, 2, 1, 0, 5, 6)), dtype, device)


def _lime_record(rectype: bytes, payload: bytes, first=False, last=False) -> bytes:
    flags = (0x8000 if first else 0) | (0x4000 if last else 0)
    header = struct.pack(">IHHQ", LIME_MAGIC, 1, flags, len(payload))
    header += rectype.ljust(128, b"\x00")[:128]
    pad = (-len(payload)) % 8
    return header + payload + b"\x00" * pad


def save_ildg(filename, u, append: bool = False) -> None:
    """Save U[mu, x, y, z, t, a, b] as a LIME/ILDG file (f64 big-endian).

    With ``append=True`` the configuration is added as a further LIME
    message, making a multi-config file readable with ``ILDG(...).load(i, ...)``.
    """
    un = host_array(u)
    nc = un.shape[-1]
    nx, ny, nz, nt = un.shape[1:5]
    arr = np.transpose(un, (4, 3, 2, 1, 0, 5, 6))
    flat = arr.reshape(-1)
    out = np.empty(2 * flat.size, dtype=">f8")
    out[0::2] = flat.real
    out[1::2] = flat.imag
    xml = (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<ildgFormat xmlns="http://www.lqcd.org/ildg">'
        "<version>1.0</version><field>su{nc}gauge</field>"
        "<precision>64</precision>"
        "<lx>{nx}</lx><ly>{ny}</ly><lz>{nz}</lz><lt>{nt}</lt>"
        "</ildgFormat>"
    ).format(nc=nc, nx=nx, ny=ny, nz=nz, nt=nt).encode("ascii")
    blob = _lime_record(b"ildg-format", xml, first=True)
    blob += _lime_record(b"ildg-binary-data", out.tobytes(), last=True)
    mode = "ab" if (append and os.path.exists(filename)) else "wb"
    with open(filename, mode) as fp:
        fp.write(blob)


def load_binary(filename, lattice, nc: int, dtype=torch.complex128,
                device="cuda") -> torch.Tensor:
    """Headerless big-endian f64 blob (LatticeQCD.jl's save_binarydata style)."""
    return load_ildg(filename, lattice, nc, dtype, device=device)
