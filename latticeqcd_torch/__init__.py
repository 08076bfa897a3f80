"""PyTorch/CUDA port of the lattice QCD sampling engine.

A second package beside the JAX reference (latticeqcd_tpu): the same
layouts and numerics in PyTorch, with the hot stencils as kernels
written by hand for NVIDIA Hopper (csrc/, built at first use). It never
imports jax. Entry points: ``python -m latticeqcd_torch.run params.toml``,
``latticeqcd_torch.system.lqcd.run_lqcd_params`` and the façade below,
which exports what latticeqcd_tpu's does: ``run_LQCD`` and
``run_LQCD_file`` (a TOML or legacy ``.jl`` file; keyword arguments such as
``dtype``, ``device`` (``cuda`` unless given), ``resume_checkpoint``,
``profile_dir``, ``make_dirs`` and ``grid`` pass through to
``system.lqcd.run_lqcd_file``) and ``run_wizard``. ``latticeqcd_torch.parallel``
is the 4D process grid on torch.distributed, and ``python -m
latticeqcd_torch.multirun`` its entry point. Importing the package
imports system.lqcd only when one of these is called, so it builds and loads
no CUDA code.
"""

import torch

from latticeqcd_torch import parallel  # noqa: F401
from latticeqcd_torch._version import __version__

# The MD link updates and staples are batched 3x3 complex products; TF32
# (about three decimal digits) must never touch them.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def run_LQCD(filename, **kwargs):
    """Run a full lattice-QCD simulation from a parameter file; returns the
    final-trajectory mean plaquette (LatticeQCD.jl's run_LQCD,
    src/system/lqcd.jl:31-34)."""
    from latticeqcd_torch.system.lqcd import run_lqcd_file

    return run_lqcd_file(filename, **kwargs)


def run_LQCD_file(filename, **kwargs):
    from latticeqcd_torch.system.lqcd import run_lqcd_file

    return run_lqcd_file(filename, **kwargs)


def run_wizard(*args, **kwargs):
    from latticeqcd_torch.system.wizard import run_wizard as _run_wizard

    return _run_wizard(*args, **kwargs)


__all__ = ["run_LQCD", "run_LQCD_file", "run_wizard", "__version__"]
