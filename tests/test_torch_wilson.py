"""Port parity: the Wilson operator, its even-odd pieces and the Wilson
kernel module (wilson_hop_packed, wilson_hop).

On the CPU the kernel wrappers take their plain versions, so these tests
pin the plain versions against the JAX package (and against the Pallas
kernels B1/B2 in interpret mode) and the hand-written backward against
autograd. The CUDA kernels themselves are held against the plain version
by the ``gpu`` test below and by chip_smoke.py, on the card, and the
body of wilson_hop_packed on the CPU by test_torch_hop_packed.py.
"""

import functools
import os
import shutil
import subprocess
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops.dirac import gammas as jgammas  # noqa: E402
from latticeqcd_tpu.ops.dirac import wilson as jw  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.measurements.scheduler import build_dirac_from_params  # noqa: E402
from latticeqcd_torch.ops.dirac import eo_pack, wilson_kernel as wk  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson as tw  # noqa: E402
from latticeqcd_torch.system.params import Params  # noqa: E402
from latticeqcd_torch.system.universe import check_supported  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

KAPPA = 0.141139
BARS = {"complex128": 1e-12, "complex64": 1e-5}
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "latticeqcd_torch", "csrc")


def _setup(lat, dtype, seed):
    rng = np.random.default_rng(seed)
    u = jw.apply_boundary_phases(jfields.hot_start(lat, 3, seed=seed))
    psi = rng.standard_normal(lat + (4, 3)) + 1j * rng.standard_normal(lat + (4, 3))
    jd = jnp.dtype(dtype)
    return u.astype(jd), jnp.asarray(psi, dtype=jd), getattr(torch, dtype)


def _err(a, b):
    return float(np.abs(np.asarray(a) - to_numpy(b)).max())


@pytest.mark.parametrize("lat", [(4, 4, 4, 4), (4, 8, 2, 4)])
@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
def test_operator_parity(lat, dtype):
    u, psi, tdt = _setup(lat, dtype, seed=sum(lat))
    ut, psit = to_torch(u), to_torch(psi)
    bar = BARS[dtype]
    for r in (1.0, 0.5):
        jd, td = jw.WilsonDirac(kappa=KAPPA, r=r), tw.WilsonDirac(kappa=KAPPA, r=r)
        assert _err(jd.apply(u, psi), td.apply(ut, psit)) < bar
        assert _err(jd.apply_dagger(u, psi), td.apply_dagger(ut, psit)) < bar
        ueo_j, ueo_t = jd.packed_links(u), td.packed_links(ut)
        for a, b in zip(ueo_j, ueo_t):
            assert _err(a, b) == 0.0
        xe = psi[: lat[0] // 2]
        xet = to_torch(xe)
        for parity, (j_ts, t_ts) in ((0, (ueo_j, ueo_t)), (1, (ueo_j[::-1], ueo_t[::-1]))):
            assert _err(jd.hop_packed(*j_ts, xe, parity), td.hop_packed(*t_ts, xet, parity)) < bar
        assert _err(jd.apply_dhat(ueo_j, xe), td.apply_dhat(ueo_t, xet)) < bar
        assert _err(jd.apply_dhat_ddag(ueo_j, xe), td.apply_dhat_ddag(ueo_t, xet)) < bar
    assert psit.dtype == tdt


def test_half_spinor_hop_and_boundary_phases():
    lat = (4, 4, 2, 4)
    u = jfields.hot_start(lat, 3, seed=2)
    for bc in ((1, 1, 1, -1), (-1, 1, -1, 1), (1, 1, 1, 1)):
        assert _err(jw.apply_boundary_phases(u, bc), tw.apply_boundary_phases(to_torch(u), bc)) == 0
    u, psi, _ = _setup(lat, "complex128", seed=4)
    jd = jw.WilsonDirac(kappa=KAPPA)
    assert _err(jd._hop_half_spinor(u, psi), wk.hop_full_reference(to_torch(u), to_torch(psi))) < 1e-12
    assert _err(jd._hop_generic(u, psi), wk.hop_full_reference(to_torch(u), to_torch(psi))) < 1e-12
    # the one plain r-generic hop (the projector form) against the JAX package's
    jd = jw.WilsonDirac(kappa=KAPPA, r=0.5)
    assert _err(jd._hop_generic(u, psi), wk.hop_full_reference(to_torch(u), to_torch(psi),
                                                               r=0.5)) < 1e-12


def test_full_d_matches_pallas_b1_b2_interpret():
    """The port's full D (the wilson_hop full mode's plain version) against
    the Pallas kernels it replaces, dslash_planes (B1) and
    dslash_planes_window (B2), run in interpret mode."""
    from latticeqcd_tpu.ops.dirac import wilson_pallas as wp

    lat = (4, 4, 4, 4)
    u, psi, _ = _setup(lat, "complex128", seed=40)
    got = wk.wilson_dslash(to_torch(u), to_torch(psi), KAPPA)
    b1 = wp.dslash_pallas(u, psi, KAPPA, interpret=True)
    assert _err(b1, got) < 1e-12
    u_k, _ = wp.links_to_planes(u)
    out_k = wp.dslash_planes_window(wp.psi_to_planes(psi), u_k, lat, KAPPA, interpret=True)
    assert _err(wp.planes_to_psi_shaped(out_k, lat, dtype=psi.dtype), got) < 1e-12


def test_pack_unpack_and_scatter_adjoint():
    lat = (4, 2, 4, 2)
    rng = np.random.default_rng(8)
    f = rng.standard_normal(lat + (4, 3)) + 0j
    for parity in (0, 1):
        from latticeqcd_tpu.ops.dirac import eo_pack as jeo

        pj = jeo.pack(jnp.asarray(f), lat, parity)
        pt = eo_pack.pack(to_torch(f), lat, parity)
        assert _err(pj, pt) == 0.0
        assert _err(jeo.unpack(pj, lat, parity), eo_pack.unpack(pt, lat, parity)) == 0.0
        s_t = eo_pack.offset_field(lat, parity)
        a = to_torch(rng.standard_normal(pt.shape) + 0j)
        b = to_torch(rng.standard_normal(pt.shape) + 0j)
        for mu in range(4):
            assert _err(jeo.gather_plus(pj, mu, s_t), eo_pack.gather_plus(pt, mu, s_t)) == 0.0
            assert _err(jeo.gather_minus(pj, mu, s_t), eo_pack.gather_minus(pt, mu, s_t)) == 0.0
            # <a, gather_minus b> = <scatter_minus a, b>
            lhs = torch.sum(a.conj() * eo_pack.gather_minus(b, mu, s_t))
            rhs = torch.sum(eo_pack.scatter_minus(a, mu, s_t).conj() * b)
            assert abs(complex(lhs - rhs)) < 1e-12


@pytest.mark.parametrize("parity", [0, 1])
def test_hop_packed_backward_gradcheck(parity):
    """The hand-written backward of WilsonHopPacked (psi by the adjoint hop,
    links by half-spinor outer products) against numerical derivatives."""
    lat = (2, 2, 2, 4)
    u = tw.apply_boundary_phases(to_torch(jfields.hot_start(lat, 3, seed=5)))
    u_e, u_o = eo_pack.pack_links(u, lat)
    u_t, u_s = (u_e, u_o) if parity == 0 else (u_o, u_e)
    g = torch.Generator().manual_seed(parity)
    x = torch.randn((1, 2, 2, 4, 4, 3), dtype=torch.complex128, generator=g)
    leaves = [t.clone().requires_grad_(True) for t in (u_t, u_s, x)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: wk.wilson_hop_packed(a, b, c, parity), leaves, fast_mode=True)


def test_dslash_backward_gradcheck():
    lat = (2, 2, 2, 4)
    u = tw.apply_boundary_phases(to_torch(jfields.hot_start(lat, 3, seed=6)))
    psi = torch.randn(lat + (4, 3), dtype=torch.complex128, generator=torch.Generator().manual_seed(1))
    leaves = [u.clone().requires_grad_(True), psi.clone().requires_grad_(True)]
    assert torch.autograd.gradcheck(lambda a, b: wk.wilson_dslash(a, b, 0.12), leaves,
                                    fast_mode=True)


def test_hop_packed_backward_matches_autograd_of_plain():
    lat = (4, 4, 2, 4)
    u = tw.apply_boundary_phases(to_torch(jfields.hot_start(lat, 3, seed=7)))
    u_e, u_o = eo_pack.pack_links(u, lat)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 4, 2, 4, 4, 3), dtype=torch.complex128, generator=g)
    cot = torch.randn((2, 4, 2, 4, 4, 3), dtype=torch.complex128, generator=g)
    for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
        leaves = [t.clone().requires_grad_(True) for t in (u_t, u_s, x)]
        a = torch.autograd.grad(wk.wilson_hop_packed(*leaves, parity), leaves, cot)
        b = torch.autograd.grad(wk.hop_packed_reference(*leaves, parity), leaves, cot)
        for ga_, gb_ in zip(a, b):
            assert float((ga_ - gb_).abs().max()) < 1e-12


@pytest.mark.parametrize("r", [0.5, 1.5])
def test_r_mode_backward_matches_autograd_of_plain(r):
    """At r != 1 the hand-written backward of WilsonHopPacked (psi by the adjoint hop
    at the same r, the links by the r-generic outer products), of WilsonDslash (the
    full D) and of the halo form's link gradients on a block cut along t against
    autograd of the plain projector form."""
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww
    from latticeqcd_torch.parallel import mesh
    from test_torch_hop_packed import block_faces

    lat = (4, 4, 2, 4)
    u = tw.apply_boundary_phases(to_torch(jfields.hot_start(lat, 3, seed=17)))
    u_e, u_o = eo_pack.pack_links(u, lat)
    g = torch.Generator().manual_seed(4)
    x, cot = (torch.randn((2, 4, 2, 4, 4, 3), dtype=torch.complex128, generator=g)
              for _ in range(2))
    for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
        leaves = [t.clone().requires_grad_(True) for t in (u_t, u_s, x)]
        a = torch.autograd.grad(wk.wilson_hop_packed(*leaves, parity, r), leaves, cot)
        b = torch.autograd.grad(wk.hop_packed_reference(*leaves, parity, r), leaves, cot)
        for ga_, gb_ in zip(a, b):
            assert float((ga_ - gb_).abs().max()) < 1e-12
        # the halo form's link gradients on each block of a t cut, from faces cut from the
        # global field, against the blocks of the global ones
        d_ut, moving, _ = wk.halo_link_grads(cot, x, parity, {}, r)
        assert float((d_ut - b[0]).abs().max()) < 1e-12
        for rank in (0, 1):
            grid = mesh.ProcessGrid((1, 1, 1, 2), lat, rank=rank)
            faces, _ = block_faces(grid, x, u_s)
            d_ut_b, moving_b, staying_b = wk.halo_link_grads(grid.block(cot), grid.block(x),
                                                             parity, faces, r)
            heads = {3: block_faces(grid, moving[3], u_s)[0][3][1]}  # the +t neighbour's
            d_us_b = wk.scatter_halo(moving_b, staying_b, heads)
            assert float((d_ut_b - grid.block(b[0], 1)).abs().max()) < 1e-12
            assert float((d_us_b - grid.block(b[1], 1)).abs().max()) < 1e-12
    psi = torch.randn(lat + (4, 3), dtype=torch.complex128, generator=g)
    cot = torch.randn(lat + (4, 3), dtype=torch.complex128, generator=g)
    leaves = [t.clone().requires_grad_(True) for t in (u, psi)]
    a = torch.autograd.grad(ww.wilson_window(*leaves, KAPPA, r), leaves, cot)
    b = torch.autograd.grad(wk.dslash_reference(*leaves, KAPPA, r), leaves, cot)
    for ga_, gb_ in zip(a, b):
        assert float((ga_ - gb_).abs().max()) < 1e-12


def test_wrapper_never_falls_back_off_cpu():
    """A tensor that is not on the CPU launches the kernel or raises; here
    (meta tensors, no card) it must raise, not take the plain version."""
    u = torch.empty((4, 2, 2, 2, 2, 3, 3), dtype=torch.complex64, device="meta")
    psi = torch.empty((2, 2, 2, 2, 4, 3), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError):
        wk.wilson_dslash(u, psi, KAPPA)
    with pytest.raises(ValueError):
        wk.wilson_hop_packed(u[:, :1], u[:, :1], psi[:1], 0)
    with pytest.raises(ValueError):
        wk.hop_packed_site(u[:, :1], u[:, :1], psi[:1], 0)


class _Launches:
    """Stands in for the kernels' C entry points: records each launch's entry point and
    arguments, and returns 0 (no error)."""

    def __init__(self):
        self.calls = []

    def entry(self, name):
        return lambda *args: self.calls.append((name, args)) or 0

    def __getattr__(self, name):  # as a ctypes library: one entry point per attribute
        return self.entry(name)


def test_wilson_r_not_one_refused_off_cpu():
    """r != 1 off the CPU: apply and hop_packed go to the kernels' wrappers, never the
    plain path (meta tensors, no card: the wrappers raise), and with the launch
    stubbed each wrapper calls its r mode's entry point (``_r``) with r, counted in
    launches and in r_launches; at r = 1 the entry points without the suffix."""
    from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww

    d = tw.WilsonDirac(kappa=KAPPA, r=0.5)
    u = torch.empty((4, 2, 2, 2, 2, 3, 3), dtype=torch.complex64, device="meta")
    psi = torch.empty((2, 2, 2, 2, 4, 3), dtype=torch.complex64, device="meta")
    before = (wk.launches, ww.launches)
    with pytest.raises(ValueError, match="CUDA"):
        d.apply(u, psi)
    with pytest.raises(ValueError, match="CUDA"):
        d.hop_packed(u[:, :1], u[:, :1], psi[:1], 0)
    assert (wk.launches, ww.launches) == before

    stub = _Launches()
    stream = mock.Mock(cuda_stream=0)
    with mock.patch.object(wk, "_check"), mock.patch.object(torch.cuda, "device"), \
            mock.patch.object(torch.cuda, "current_stream", return_value=stream), \
            mock.patch.object(wk, "_fn", lambda lib, entry, dtype: stub.entry(entry)), \
            mock.patch.object(ww, "_lib", lambda: stub):
        for dirac, suffix in ((d, "_r"), (tw.WilsonDirac(kappa=KAPPA), "")):
            n = (wk.launches, wk.r_launches, ww.launches, ww.r_launches)
            with torch.no_grad():
                dirac.apply(u, psi)
                dirac.hop_packed(u[:, :1], u[:, :1], psi[:1], 0)
            r_mode = int(suffix == "_r")
            assert (wk.launches, wk.r_launches, ww.launches, ww.r_launches) == (
                n[0] + 1, n[1] + r_mode, n[2] + 1, n[3] + r_mode)
            (window, wargs), (brick, bargs) = stub.calls[-2:]
            assert window == f"wilson_window{suffix}_c64" and brick == f"wilson_hop_brick{suffix}"
            if r_mode:  # r follows kappa in the window's arguments, the stream in the brick's
                assert wargs[7:9] == (KAPPA, 0.5) and bargs[-1] == 0.5


@pytest.mark.parametrize("device,card", [("cuda", True), ("cpu", False)])
def test_check_supported_refuses_r_not_one_off_cpu(device, card):
    """Wilson and clover r != 1 pass check_supported on the card as on the CPU (the
    kernels' r mode); an unknown measurement operator is still refused there."""
    for kind in ("Wilson", "WilsonClover"):
        for r in (0.5, 1.0):
            check_supported(Params(L=(4, 4, 4, 4), NC=3, quench=False, Dirac_operator=kind,
                                   hop=KAPPA, r=r, update_method="HMC"), device=device)
    bad = {"methodname": "Pion_correlator", "fermion_parameters": {"Dirac_operator": "Overlap"}}
    with pytest.raises(ValueError, match="Overlap"):
        check_supported(Params(L=(4, 4, 4, 4), NC=3, quench=True, update_method="HMC",
                               measurement_methods=[bad]), device=device)
    assert torch.device(device).type == ("cuda" if card else "cpu")


def test_build_dirac_from_params_defaults_to_the_card():
    """A measurement's operator holds no device: built from its parameters alone (r =
    0.5 too), it launches the kernels on whatever fields it is given, the card's by
    default, and takes the plain versions only on the CPU (meta tensors: the dispatch)."""
    d = build_dirac_from_params({"Dirac_operator": "Wilson", "hop": KAPPA, "r": 0.5}, (4, 4, 4, 4))
    assert d == tw.WilsonDirac(kappa=KAPPA, r=0.5)
    assert build_dirac_from_params({"Dirac_operator": "Wilson", "hop": KAPPA}, (4, 4, 4, 4)).r == 1.0
    u = torch.empty((4, 2, 2, 2, 2, 3, 3), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        d.apply(u, torch.empty((2, 2, 2, 2, 4, 3), dtype=torch.complex64, device="meta"))


@pytest.mark.parametrize("device,refused", [("meta", True), ("cpu", False)])
def test_wilson_r_not_one_measurement_refused_before_any_trajectory(device, refused):
    """A measurement's own Wilson r != 1 is built as such and passes check_supported,
    which runs before the first trajectory, off the CPU as on it; its operator applied
    off the CPU goes to the kernel (meta tensors: the wrapper raises) and on the CPU
    to the plain version, which matches the JAX package's operator at r = 0.5."""
    fparams = {"Dirac_operator": "Wilson", "hop": KAPPA, "r": 0.5}
    p = Params(L=(4, 4, 4, 4), NC=3, quench=True, update_method="HMC",
               measurement_methods=[{"methodname": "Pion_correlator", "fermion_parameters": fparams}])
    d = build_dirac_from_params(fparams, p.L)
    assert d.r == 0.5
    check_supported(p, device=device)
    if refused:
        u = torch.empty((4, 4, 4, 4, 4, 3, 3), dtype=torch.complex64, device=device)
        with pytest.raises(ValueError, match="CUDA"):
            d.apply(u, torch.empty((4, 4, 4, 4, 4, 3), dtype=torch.complex64, device=device))
    else:
        u, psi, _ = _setup(p.L, "complex128", seed=12)
        assert _err(jw.WilsonDirac(kappa=KAPPA, r=0.5).apply(u, psi),
                    d.apply(to_torch(u), to_torch(psi))) < 1e-12
    fparams["r"] = 1.0
    check_supported(p, device=device)


def test_kernel_spin_tables_match_gammas(tmp_path):
    """The compile-time W tables of csrc/wilson_spin.h (compiled here with
    the host C++ compiler) factor (1 -+ gamma_mu) exactly, and give -+gamma_mu
    itself as the r mode reads them (wilson_dir.h, lane_rebuild_r):
    (-+g_mu phi)_j = i^k phi_h and (-+g_mu phi)_h = i^(4-k) phi_j."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = tmp_path / "tables.cpp"
    src.write_text('#include "wilson_spin.h"\n#include <cstdio>\n'
                   "int main() { for (int mu = 0; mu < 4; ++mu) for (int h = 0; h < 2; ++h)"
                   ' std::printf("%d %d\\n", w_j(mu, h), w_k(mu, h)); }\n')
    exe = tmp_path / "tables"
    subprocess.run([cxx, "-std=c++17", "-I", CSRC, str(src), "-o", str(exe)], check=True)
    rows = [tuple(map(int, line.split()))
            for line in subprocess.run([str(exe)], capture_output=True, text=True,
                                       check=True).stdout.split("\n") if line]
    for sign in (-1, 1):
        for mu in range(4):
            w = np.zeros((4, 2), dtype=complex)
            for h in range(2):
                j, k = rows[2 * mu + h]
                w[h, h] = 1.0
                w[j, h] = 1j ** (k + (2 if sign == 1 else 0))
            np.testing.assert_allclose(w @ w.conj().T, np.eye(4) + sign * jgammas.GAMMA[mu],
                                       atol=1e-15)
            g = np.zeros((4, 4), dtype=complex)
            for h in range(2):
                j, k = rows[2 * mu + h]
                k += 2 if sign == 1 else 0
                g[j, h], g[h, j] = 1j ** k, 1j ** (4 - k)
            np.testing.assert_allclose(g, sign * jgammas.GAMMA[mu], atol=1e-15)


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu():
    """On the card: wilson_hop_packed (forward and psi backward) against the plain
    version and against wilson_hop's packed mode, and wilson_hop's full mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu tests/test_torch_wilson.py)")
    dev = torch.device("cuda")
    for lat in ((4, 8, 2, 4), (2, 4, 2, 6)):
        for dtype, bar in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
            u = tw.apply_boundary_phases(
                to_torch(jfields.hot_start(lat, 3, seed=9), device=dev, dtype=dtype))
            g = torch.Generator(device=dev).manual_seed(2)
            psi = torch.randn(lat + (4, 3), dtype=dtype, device=dev, generator=g)
            before = wk.site_launches["full"]
            out = wk.wilson_dslash(u, psi, KAPPA)
            assert wk.site_launches["full"] == before + 1
            assert float((out - wk.dslash_reference(u, psi, KAPPA)).abs().max()) < bar
            u_e, u_o = eo_pack.pack_links(u, lat)
            half = (lat[0] // 2,) + lat[1:] + (4, 3)
            x = torch.randn(half, dtype=dtype, device=dev, generator=g)
            cot = torch.randn(half, dtype=dtype, device=dev, generator=g)
            for parity, (u_t, u_s) in ((0, (u_e, u_o)), (1, (u_o, u_e))):
                before = wk.launches
                got = wk.wilson_hop_packed(u_t, u_s, x, parity)
                assert wk.launches == before + 1
                ref = wk.hop_packed_reference(u_t, u_s, x, parity)
                assert float((got - ref).abs().max()) < bar
                site = wk.hop_packed_site(u_t, u_s, x, parity)
                assert float((got - site).abs().max()) < bar
                leaf = x.clone().requires_grad_(True)
                d_k, = torch.autograd.grad(wk.wilson_hop_packed(u_t, u_s, leaf, parity), leaf, cot)
                d_p, = torch.autograd.grad(wk.hop_packed_reference(u_t, u_s, leaf, parity), leaf,
                                           cot)
                assert float((d_k - d_p).abs().max()) < bar
