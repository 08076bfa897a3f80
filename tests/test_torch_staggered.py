"""Port parity: the staggered operator, its even-odd pieces and the
staggered_w kernel module.

On the CPU the kernel wrappers take their plain versions, so these tests
pin the plain versions against the JAX package (and against the Pallas
kernel B3 in interpret mode) and the hand-written backward against
autograd. The CUDA kernel itself is held against the plain version by
the ``gpu`` test below and by chip_smoke.py, on the card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops.dirac import staggered as js  # noqa: E402
from latticeqcd_tpu.ops.dirac import wilson as jw  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops.dirac import eo_pack, staggered as ts  # noqa: E402
from latticeqcd_torch.ops.dirac import staggered_kernel as sk  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson as tw  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

MASS = 0.5
BARS = {"complex128": 1e-12, "complex64": 1e-5}
LATTICES = [(4, 4, 4, 4), (4, 8, 2, 2), (2, 4, 2, 6)]


def _setup(lat, dtype, seed):
    """Phased links and a random field, in the JAX package's arrays and the port's tensors."""
    rng = np.random.default_rng(seed)
    u = jw.apply_boundary_phases(jfields.hot_start(lat, 3, seed=seed)).astype(jnp.dtype(dtype))
    psi = jnp.asarray(rng.standard_normal(lat + (3,)) + 1j * rng.standard_normal(lat + (3,)),
                      dtype=jnp.dtype(dtype))
    return u, psi, to_torch(u), to_torch(psi)


def _err(a, b):
    return float(np.abs(np.asarray(a) - to_numpy(b)).max())


def test_ks_phases_equal():
    for lat in LATTICES + [(3, 2, 5, 2)]:
        for a, b in zip(js.ks_phases(lat), ts.ks_phases(lat)):
            np.testing.assert_array_equal(a, b)
    for lat in LATTICES:
        jd, td = js.StaggeredDirac(MASS, lat), ts.StaggeredDirac(MASS, lat)
        for parity in (0, 1):
            # the kernel's sign rule against eta packed from the site fields
            np.testing.assert_array_equal(np.asarray(jd._packed_eta(parity)),
                                          td._packed_eta(parity))


@pytest.mark.parametrize("lat", LATTICES)
@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
def test_operator_parity(lat, dtype):
    u, psi, ut, psit = _setup(lat, dtype, seed=sum(lat))
    bar = BARS[dtype]
    jd, td = js.StaggeredDirac(MASS, lat), ts.StaggeredDirac(MASS, lat)
    assert _err(jd.dslash(u, psi), td.dslash(ut, psit)) < bar
    assert _err(jd.apply(u, psi), td.apply(ut, psit)) < bar
    assert _err(jd.apply_dagger(u, psi), td.apply_dagger(ut, psit)) < bar
    assert _err(jd.apply_w_even(u, psi), td.apply_w_even(ut, psit)) < bar
    assert _err(jd.apply_ddag_d(u, psi), td.apply_ddag_d(ut, psit)) < bar
    ueo_j, ueo_t = jd.packed_links(u), td.packed_links(ut)
    for a, b in zip(ueo_j, ueo_t):
        assert _err(a, b) == 0.0
    xe = jd.pack(psi, 0)
    xet = td.pack(psit, 0)
    assert _err(xe, xet) == 0.0
    assert _err(jd.unpack(xe, 0), td.unpack(xet, 0)) == 0.0
    for parity, (j_ts, t_ts) in ((0, (ueo_j, ueo_t)), (1, (ueo_j[::-1], ueo_t[::-1]))):
        assert _err(jd._packed_dslash(*j_ts, xe, parity), td._packed_dslash(*t_ts, xet, parity)) < bar
    got = td.apply_w_packed(ueo_t, xet)
    assert got.dtype == psit.dtype
    assert _err(jd.apply_w_packed(ueo_j, xe), got) < bar
    # the packed W is the masked full-volume W up to the layout
    assert float((td.unpack(got, 0) - td.apply_w_even(ut, td.unpack(xet, 0))).abs().max()) < bar


def test_w_matches_pallas_b3_interpret():
    """The port's W (the staggered_w kernel's plain version) against the
    Pallas kernel it replaces, w_planes_window (B3), in interpret mode."""
    from latticeqcd_tpu.ops.dirac import staggered_pallas as sp

    lat = (4, 4, 4, 4)
    jd, td = js.StaggeredDirac(MASS, lat), ts.StaggeredDirac(MASS, lat)
    u = jfields.hot_start(lat, 3, seed=50)
    rng = np.random.default_rng(51)
    phi_e = jnp.asarray(rng.standard_normal((2, 4, 4, 4, 3)) + 1j * rng.standard_normal((2, 4, 4, 4, 3)))
    b3 = sp.apply_w_pallas(jd, u, phi_e, interpret=True)
    ueo = td.packed_links(tw.apply_boundary_phases(to_torch(np.asarray(u)), td.bc))
    got = sk.staggered_w(*ueo, to_torch(phi_e), MASS)
    assert _err(b3, got) < 1e-12


@pytest.mark.parametrize("parity", [0, 1])
def test_hop_backward_gradcheck(parity):
    """The hand-written backward of StaggeredHopPacked (the field by minus the
    reverse hop, the links by eta-weighted outer products) against numerical
    derivatives."""
    lat = (2, 2, 2, 4)
    u = tw.apply_boundary_phases(to_torch(np.asarray(jfields.hot_start(lat, 3, seed=5))))
    u_e, u_o = eo_pack.pack_links(u, lat)
    u_t, u_s = (u_e, u_o) if parity == 0 else (u_o, u_e)
    x = torch.randn((1, 2, 2, 4, 3), dtype=torch.complex128,
                    generator=torch.Generator().manual_seed(parity))
    leaves = [t.clone().requires_grad_(True) for t in (u_t, u_s, x)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: sk.staggered_hop_packed(a, b, c, parity), leaves, fast_mode=True)


@pytest.mark.parametrize("lat", [(4, 4, 2, 4), (2, 4, 2, 6)])
def test_hop_backward_matches_autograd_of_plain(lat):
    u = tw.apply_boundary_phases(to_torch(np.asarray(jfields.hot_start(lat, 3, seed=7))))
    u_e, u_o = eo_pack.pack_links(u, lat)
    g = torch.Generator().manual_seed(3)
    half = (lat[0] // 2,) + lat[1:] + (3,)
    x = torch.randn(half, dtype=torch.complex128, generator=g)
    cot = torch.randn(half, dtype=torch.complex128, generator=g)
    for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
        leaves = [t.clone().requires_grad_(True) for t in (u_t, u_s, x)]
        a = torch.autograd.grad(sk.staggered_hop_packed(*leaves, parity), leaves, cot)
        b = torch.autograd.grad(sk.staggered_hop_packed_reference(*leaves, parity), leaves, cot)
        for ga_, gb_ in zip(a, b):
            assert float((ga_ - gb_).abs().max()) < 1e-12


def test_w_packed_gradient_path_matches_fused():
    """apply_w_packed takes the fused W without a gradient and two
    differentiable hops with one; both give the same W."""
    lat = (4, 4, 2, 4)
    u, _, ut, _ = _setup(lat, "complex128", seed=9)
    td = ts.StaggeredDirac(MASS, lat)
    uu = ut.clone().requires_grad_(True)
    x = torch.randn((2,) + lat[1:] + (3,), dtype=torch.complex128,
                    generator=torch.Generator().manual_seed(4))
    composed = td.apply_w_packed(td.packed_links(uu), x)
    assert composed.requires_grad
    with torch.no_grad():
        fused = td.apply_w_packed(td.packed_links(uu), x)
    assert float((composed.detach() - fused).abs().max()) < 1e-13


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is not on the CPU launches the kernel or raises; here
    (meta tensors, no card) it must raise, not take the plain version. The
    full-volume torch operator refuses such a tensor by name."""
    u = torch.empty((4, 2, 2, 2, 2, 3, 3), dtype=torch.complex64, device="meta")
    psi = torch.empty((2, 2, 2, 2, 3), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError):
        sk.staggered_w(u, u, psi, MASS)
    with pytest.raises(ValueError):
        sk.staggered_w_fused(u, u, psi, MASS)
    with pytest.raises(ValueError):
        sk.staggered_hop_packed(u, u, psi, 0)
    d = ts.StaggeredDirac(MASS, (4, 2, 2, 2))
    with pytest.raises(NotImplementedError, match="A11"):
        d.dslash(torch.empty((4, 4, 2, 2, 2, 3, 3), dtype=torch.complex64, device="meta"),
                 torch.empty((4, 2, 2, 2, 3), dtype=torch.complex64, device="meta"))


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu():
    """On the card: the packed hop for both parities, the paths' two-launch W
    and the one-launch W against the plain version, with their counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu tests/test_torch_staggered.py)")
    dev = torch.device("cuda")
    for lat in LATTICES:
        for dtype, bar in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
            u = tw.apply_boundary_phases(to_torch(np.asarray(jfields.hot_start(lat, 3, seed=9)),
                                                  device=dev, dtype=dtype))
            u_e, u_o = eo_pack.pack_links(u, lat)
            g = torch.Generator(device=dev).manual_seed(2)
            x = torch.randn((lat[0] // 2,) + lat[1:] + (3,), dtype=dtype, device=dev, generator=g)
            ref = sk.staggered_w_reference(u_e, u_o, x, MASS)
            before = (sk.launches, sk.w_launches, sk.fused_launches)
            got = sk.staggered_w(u_e, u_o, x, MASS)
            assert (sk.launches, sk.w_launches, sk.fused_launches) == (
                before[0] + 1, before[1] + 1, before[2])
            assert float((got - ref).abs().max()) < bar
            got = sk.staggered_w_fused(u_e, u_o, x, MASS)
            assert (sk.launches, sk.w_launches, sk.fused_launches) == (
                before[0] + 1, before[1] + 1, before[2] + 1)
            assert float((got - ref).abs().max()) < bar
            for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
                got = sk.staggered_hop_packed(u_t, u_s, x, parity)
                ref = sk.staggered_hop_packed_reference(u_t, u_s, x, parity)
                assert float((got - ref).abs().max()) < bar
