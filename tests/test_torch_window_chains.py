"""The chain axis of csrc/wilson_window.cu (the full Wilson D of batched chains).

n independent lattices with a leading chain axis go through one launch of the
kernel's chains entry points. Held here on the CPU, at 1e-12 (complex128) and
1e-5 (complex64):

* the kernel body, compiled with g++ against test_torch_hop_packed.py's mock
  headers (bulk copies a memcpy, the mbarrier wait and __syncthreads a
  barrier, the block's CUDA threads as cooperative contexts on one OS
  thread), at the tiles of the entry
  points, one and two chains with different links (the chain instantiation as
  the launch function picks it), x cut into uneven chunks, at r = 1 and in the
  r mode at r = 0.5, each chain against the plain D;
* the autograd Function with a chain axis: forward and the gradients of the
  links and the spinor against the per-chain calls.

The ``gpu`` test holds the kernel on the card against its plain version (run:
python -m pytest -m gpu tests/test_torch_window_chains.py -n 0).
"""

import subprocess

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import fields  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson as tw  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson_kernel as wk  # noqa: E402
from latticeqcd_torch.ops.dirac import wilson_window_kernel as ww  # noqa: E402

LAT = (5, 3, 4, 6)
KAPPA = 0.13

# run<R, tile, GENERIC_R>: the launch function's grid (blocks x chains) for nchain chains, the
# kernel without the chain offsets for one chain; each block's threads run by run_block
_HARNESS = """
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "body.inc"
namespace { alignas(16) unsigned char smem[1 << 20]; }
template <typename R, int BY, int BZ, int TSMAX, int MINB, bool PREFETCH, bool GENERIC_R,
          bool CHAINS>
int run(int lx, int ly, int lz, int lt, int chunk, double kappa, int nchain, double r) {
  using V = typename Vec<R>::type;
  const long vol = (long)lx * ly * lz * lt;
  std::vector<V> u(36 * vol * nchain), psi(12 * vol * nchain), out(12 * vol * nchain);
  if (fread(u.data(), sizeof(V), u.size(), stdin) != u.size()) return 1;
  if (fread(psi.data(), sizeof(V), psi.size(), stdin) != psi.size()) return 1;
  std::memset(out.data(), 0xff, out.size() * sizeof(V));  // a site never written shows as NaN
  const int nts = (lt + TSMAX - 1) / TSMAX, ts = (lt + nts - 1) / nts;
  const int blocks = ((lx + chunk - 1) / chunk) * ((ly + BY - 1) / BY) * ((lz + BZ - 1) / BZ) * nts;
  const int threads = 3 * BY * BZ * ts;
  for (int c = 0; c < nchain; ++c)
    for (int b = 0; b < blocks; ++b) {
      MockBarrier bar(threads);
      block_barrier = &bar;
      std::memset(smem, 0xff, sizeof smem);  // a slot read before it is copied shows as NaN
      run_block(threads, [&](int tid) {
        threadIdx = dim3{(unsigned)tid, 1, 1};
        blockIdx = dim3{(unsigned)b, (unsigned)c, 1};
        wilson_window_kernel<R, BY, BZ, TSMAX, MINB, PREFETCH, false, GENERIC_R, CHAINS>(
            u.data(), psi.data(), out.data(), lx, ly, lz, lt, ts, chunk, (R)kappa, {}, (R)r,
            36 * vol, 12 * vol);
      });
    }
  fwrite(out.data(), sizeof(V), out.size(), stdout);
  return 0;
}
// the instantiation the launch function picks: the r mode at r != 1, the chain offsets for
// more than one chain
template <typename R, int BY, int BZ, int TSMAX, int MINB, bool PREFETCH>
int run_at(const int (&l)[5], double kappa, int nchain, double r) {
  if (r == 1.0)
    return nchain == 1 ? run<R, BY, BZ, TSMAX, MINB, PREFETCH, false, false>(
                             l[0], l[1], l[2], l[3], l[4], kappa, nchain, r)
                       : run<R, BY, BZ, TSMAX, MINB, PREFETCH, false, true>(
                             l[0], l[1], l[2], l[3], l[4], kappa, nchain, r);
  return nchain == 1 ? run<R, BY, BZ, TSMAX, MINB, PREFETCH, true, false>(
                           l[0], l[1], l[2], l[3], l[4], kappa, nchain, r)
                     : run<R, BY, BZ, TSMAX, MINB, PREFETCH, true, true>(
                           l[0], l[1], l[2], l[3], l[4], kappa, nchain, r);
}
int main(int argc, char** argv) {
  int l[5];
  for (int i = 0; i < 5; ++i) l[i] = atoi(argv[i + 1]);
  const double kappa = atof(argv[6]), r = atof(argv[9]);
  const int c128 = atoi(argv[7]), nchain = atoi(argv[8]);
  if (!c128) return run_at<float, WILSON_WINDOW_TILE_C64>(l, kappa, nchain, r);
  return r == 1.0 ? run_at<double, WILSON_WINDOW_TILE_C128>(l, kappa, nchain, r)
                  : run_at<double, WILSON_WINDOW_TILE_C128_R>(l, kappa, nchain, r);
}
"""


@pytest.fixture(scope="module")
def window_chains_exe(tmp_path_factory):
    # imported here: its mock headers' module imports the JAX package, which the card's
    # machine lacks
    from test_torch_halo_bodies import _compile

    return _compile(tmp_path_factory, "wilson_window", "// Launch one wave", _HARNESS)


def _chain_links(nchain, dtype, lat=LAT):
    """Links with the boundary phases, one hot start per chain (different links)."""
    return torch.stack([tw.apply_boundary_phases(fields.hot_start(lat, 3, seed=sum(lat) + c,
                                                                  device="cpu")).to(dtype)
                        for c in range(nchain)])


@pytest.mark.parametrize("r", [1.0, 0.5], ids=["r1", "r0.5"])
@pytest.mark.parametrize("nchain", [1, 2])
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_window_chain_body_on_the_cpu(window_chains_exe, dtype, nchain, r):
    """The kernel body over a chain axis, x = 5 cut into chunks of 3, each chain against
    the plain D of its own links."""
    tdt = getattr(torch, dtype)
    u = _chain_links(nchain, tdt)
    psi = torch.randn((nchain,) + LAT + (4, 3), dtype=tdt,
                      generator=torch.Generator().manual_seed(7))
    out = _run_body(window_chains_exe, u, psi, nchain, dtype, r)
    bar = 1e-12 if dtype == "complex128" else 1e-5
    for c in range(nchain):
        ref = to_numpy(wk.dslash_reference(u[c], psi[c], KAPPA, r))
        assert float(np.abs(out[c] - ref).max()) < bar, c


def _run_body(exe, u, psi, nchain, dtype, r):
    """The body's D of every chain, x cut into chunks of 3."""
    res = subprocess.run(
        [exe, *map(str, LAT), "3", repr(KAPPA), str(int(dtype == "complex128")), str(nchain),
         repr(r)],
        input=to_numpy(u).tobytes() + to_numpy(psi).tobytes(), capture_output=True, check=True)
    return np.frombuffer(res.stdout, dtype=np.dtype(dtype)).reshape(psi.shape)


@pytest.mark.parametrize("r", [1.0, 0.7], ids=["r1", "r0.7"])
def test_window_function_takes_a_chain_axis(r):
    """wilson_window with a leading chain axis on the CPU: forward and the backward for
    the links and the spinor equal to the per-chain calls."""
    u = _chain_links(2, torch.complex128, lat=(3, 4, 2, 4))
    g = torch.Generator().manual_seed(13)
    x, cot = (torch.randn((2, 3, 4, 2, 4, 4, 3), dtype=torch.complex128, generator=g)
              for _ in range(2))
    leaves = [t.detach().clone().requires_grad_(True) for t in (u, x)]
    out = ww.wilson_window(*leaves, KAPPA, r)
    grads = torch.autograd.grad(out, leaves, cot)
    for i in range(2):
        one = [t[i].detach().clone().requires_grad_(True) for t in (u, x)]
        out1 = ww.wilson_window(*one, KAPPA, r)
        grads1 = torch.autograd.grad(out1, one, cot[i])
        assert float((out[i] - out1).detach().abs().max()) < 1e-14
        for a, b in zip(grads, grads1):
            assert float((a[i] - b).abs().max()) < 1e-14


@pytest.mark.gpu
def test_window_chains_on_gpu():
    """On the card: one launch for 3 chains at r = 1 and r = 0.5, forward and the link
    backward, against the plain per-chain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU "
                    "(run: python -m pytest -m gpu tests/test_torch_window_chains.py)")
    dev = torch.device("cuda")
    for dtype, bar in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
        u = _chain_links(3, dtype).to(dev)
        g = torch.Generator(device=dev).manual_seed(24)
        x, cot = (torch.randn((3,) + LAT + (4, 3), dtype=dtype, device=dev, generator=g)
                  for _ in range(2))
        for r in (1.0, 0.5):
            before = ww.launches
            got = ww.wilson_window(u, x, KAPPA, r)
            torch.cuda.synchronize()
            assert ww.launches == before + 1
            assert float((got - wk.dslash_reference(u, x, KAPPA, r)).abs().max()) < bar
            leaf = u.clone().requires_grad_(True)
            (d_u,) = torch.autograd.grad(ww.wilson_window(leaf, x, KAPPA, r), leaf, cot)
            leaf = u.clone().requires_grad_(True)
            (d_ref,) = torch.autograd.grad(wk.dslash_reference(leaf, x, KAPPA, r), leaf, cot)
            assert float((d_u - d_ref).abs().max()) < bar * max(1.0, float(d_ref.abs().max()))
