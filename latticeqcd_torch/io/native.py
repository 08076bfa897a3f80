"""Native configuration and checkpoint files (.npz).

Counterpart of latticeqcd_tpu/io/native.py. A configuration file is a
NumPy archive holding the links as ``u``. A checkpoint adds the
trajectory counter ``itrj``, any ``extra_*`` arrays and the run's
torch.Generator state under ``torch_rng_state``, so that a run resumes
bit for bit. It never writes the JAX package's ``rng_key``: jax.random
streams cannot be continued in torch. The JAX package reads a port
checkpoint as its own (``u``, ``itrj``, ``extra_*``; other keys are
ignored), and a JAX checkpoint loads here with its ``rng_key`` as a
numpy array, which a run does not use.
"""

from __future__ import annotations

import numpy as np
import torch

from latticeqcd_torch.convert import to_numpy

_NUMPY_DTYPE = {torch.complex64: np.complex64, torch.complex128: np.complex128}


def host_array(u) -> np.ndarray:
    """The links as a numpy array on the host (a tensor on any device, or an array)."""
    return to_numpy(u) if isinstance(u, torch.Tensor) else np.asarray(u)


def to_links(arr: np.ndarray, dtype=torch.complex128, device="cuda") -> torch.Tensor:
    """A numpy array of links -> a tensor of ``dtype`` on ``device``: cast on the
    host (round to nearest, as the JAX package's jnp.asarray does), then one copy."""
    host = np.require(arr, dtype=_NUMPY_DTYPE[dtype], requirements=["C", "W"])
    return torch.from_numpy(host).to(device)


def save_u(filename, u) -> None:
    np.savez_compressed(filename, u=host_array(u))


def load_u(filename, dtype=torch.complex128, device="cuda") -> torch.Tensor:
    with np.load(filename) as z:
        return to_links(z["u"], dtype, device)


def save_checkpoint(filename, u, rng_state=None, itrj=None, extra=None) -> None:
    """rng_state: a torch.Generator's get_state() (a uint8 tensor)."""
    payload = {"u": host_array(u)}
    if rng_state is not None:
        payload["torch_rng_state"] = to_numpy(rng_state).astype(np.uint8)
    if itrj is not None:
        payload["itrj"] = np.asarray(itrj)
    if extra:
        for k, v in extra.items():
            payload["extra_" + k] = np.asarray(v)
    np.savez_compressed(filename, **payload)


def load_checkpoint(filename, dtype=torch.complex128, device="cuda") -> dict:
    """{"u": links on ``device``, "itrj": int, "torch_rng_state": uint8 tensor on
    the host (for Generator.set_state), "rng_key": a JAX checkpoint's key as a
    numpy array, and each extra_<name> as <name>: a numpy array}; keys absent
    from the file are absent here."""
    with np.load(filename) as z:
        out = {"u": to_links(z["u"], dtype, device)}
        if "torch_rng_state" in z:
            out["torch_rng_state"] = torch.from_numpy(z["torch_rng_state"].astype(np.uint8))
        if "rng_key" in z:
            out["rng_key"] = np.asarray(z["rng_key"])
        if "itrj" in z:
            out["itrj"] = int(z["itrj"])
        for k in z.files:
            if k.startswith("extra_"):
                out[k[6:]] = np.asarray(z[k])
    return out
