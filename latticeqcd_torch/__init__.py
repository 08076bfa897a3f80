"""PyTorch/CUDA port of the lattice QCD sampling engine.

A second package beside the JAX reference (latticeqcd_tpu): the same
layouts and numerics in PyTorch, with the hot stencils as kernels
written by hand for NVIDIA Hopper (csrc/, built at first use). It never
imports jax. Entry points: ``python -m latticeqcd_torch.run params.toml``
and ``latticeqcd_torch.system.lqcd.run_lqcd_params``.
"""

import torch

from latticeqcd_torch._version import __version__

# The MD link updates and staples are batched 3x3 complex products; TF32
# (about three decimal digits) must never touch them.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["__version__"]
