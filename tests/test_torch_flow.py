"""Port parity: the Wilson gradient flow (smearing/gradientflow.py)."""

import functools
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.smearing import gradientflow as _jgf  # noqa: E402,F401
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import gauge_action as tga  # noqa: E402
from latticeqcd_torch.ops import sun as tsun  # noqa: E402
from latticeqcd_torch.smearing import gradientflow as tgf  # noqa: E402

jgf = sys.modules["latticeqcd_tpu.smearing.gradientflow"]
to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)


@pytest.mark.parametrize("nc", [2, 3])
def test_flow_matches_jax(nc):
    """5 RK3 steps of 0.02 on hot links, and the flow action's coupling."""
    u = np.asarray(jfields.hot_start(LAT, nc, seed=34 + nc))
    ref = np.asarray(jgf.gradientflow(nc, nflow=5, eps=0.02).flow(u))
    gf = tgf.gradientflow(to_torch(u), nflow=5, eps=0.02)
    assert gf.action.plaq_coeff == jgf.wilson_flow_action(nc).plaq_coeff == nc
    got = gf.flow(to_torch(u))
    assert np.abs(ref - to_numpy(got)).max() < 1e-12
    assert float(tsun.unitarity_defect(got)) < 1e-12


def test_flow_complex64_within_single_precision():
    u = np.asarray(jfields.hot_start(LAT, 3, seed=3))
    ref = np.asarray(jgf.gradientflow(3, nflow=5, eps=0.02).flow(u))
    got = tgf.gradientflow(3, nflow=5, eps=0.02).flow(to_torch(u, dtype=torch.complex64))
    assert got.dtype == torch.complex64
    assert np.abs(ref - to_numpy(got)).max() < 1e-5


def test_flow_raises_the_plaquette():
    u = to_torch(np.asarray(jfields.hot_start(LAT, 3, seed=34)))
    gf = tgf.gradientflow(3, nflow=20, eps=0.02)
    p0 = float(tga.mean_plaquette(u))
    u1 = gf.flow(u)
    u2 = gf.flow(u1)
    assert p0 < float(tga.mean_plaquette(u1)) < float(tga.mean_plaquette(u2))


def test_flow_heat_kernel_normalization():
    """A weak transverse Fourier mode decays as exp(-p_hat^2 t), as in
    tests/test_smearing.py: the flow time has the standard normalisation."""
    lat = (8, 4, 4, 4)
    nc = 2
    amp = 1e-4
    kx = 2 * np.pi / lat[0]
    x = np.arange(lat[0])
    a = np.zeros((4, *lat, nc, nc), dtype=np.complex128)
    prof = amp * np.cos(kx * x)[:, None, None, None]
    a[1, ..., 0, 0] = prof / 2
    a[1, ..., 1, 1] = -prof / 2
    u = tsun.expi_hermitian(to_torch(a), 1.0)
    t, eps = 0.3, 0.01
    uf = tgf.gradientflow(nc, nflow=int(t / eps), eps=eps).flow(u)
    theta = np.imag(to_numpy(uf[1])[..., 0, 0])
    coef = 2 * np.mean(theta * np.cos(kx * x)[:, None, None, None]) / (amp / 2)
    expected = np.exp(-4 * np.sin(kx / 2) ** 2 * t)
    assert abs(coef - expected) < 0.02 * expected, (coef, expected)
