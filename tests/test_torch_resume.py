"""Port: saving from run_lqcd_params, checkpoints across the two packages, and
bitwise resume on the CPU.

A run that saves writes conf_<itrj>.<ext> in its format and checkpoint.npz
with the links, the trajectory counter and the torch.Generator state; a
run of 3 trajectories resumed for 3 more ends on the links of a straight
run of 6, bit for bit. Checkpoints load across both packages: a port
checkpoint gives the JAX package its links and counter, and a JAX
checkpoint gives the port the same, its draws restarting from randomseed.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu import io as jio  # noqa: E402
from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch import io as tio  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import gauge_action as tga  # noqa: E402
from latticeqcd_torch.system.lqcd import Savedata, run_lqcd_params  # noqa: E402
from latticeqcd_torch.system.params import Params  # noqa: E402
from latticeqcd_torch.utils.logger import VerbosePrint  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXT = {"NPZ": "npz", "ILDG": "ildg", "BridgeText": "txt", "JLD": "jld2"}
# cold starts, so that the trajectories are accepted and the links move
ACTIONS = {
    "quenched SU(3)": dict(quench=True, beta=6.0, dtau=0.1, MDsteps=5),
    "Wilson": dict(quench=False, Dirac_operator="Wilson", hop=0.141139, beta=6.0, dtau=0.1,
                   MDsteps=3, eps=1e-16),
}


def _params(save_dir, nsteps, fmt="NPZ", every=1, **kw):
    base = dict(L=LAT, NC=3, initial="cold", update_method="HMC", Nsteps=nsteps, randomseed=9,
                verboselevel=1, saveU_format=fmt, saveU_dir=str(save_dir), saveU_every=every,
                measurement_methods=[{"methodname": "Plaquette"}],
                measuredir=str(save_dir / "measure"))
    base.update(kw)
    return Params(**base)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# measured on both sides of a resume: a gauge observable and a noisy fermionic one
SERIES = [{"methodname": "Plaquette"},
          {"methodname": "Chiral_condensate", "Nr": 1, "eps": 1e-16,
           "fermion_parameters": {"Dirac_operator": "Wilson", "hop": 0.141139}}]


@pytest.mark.parametrize("action", list(ACTIONS))
def test_resume_is_bitwise(tmp_path, action):
    """6 trajectories straight against 3, then a resume from the checkpoint for 3
    more: the same links, dH, saved files and measurement series."""
    a, b = tmp_path / "straight", tmp_path / "resumed"
    a.mkdir(), b.mkdir()
    hist_a, hist_b = [], []
    kw = dict(ACTIONS[action], measurement_methods=SERIES)
    plaq_a = run_lqcd_params(_params(a, 6, **kw), device="cpu", history=hist_a)
    run_lqcd_params(_params(b, 3, **kw), device="cpu", history=hist_b)
    ck = tio.load_checkpoint(b / "checkpoint.npz", device="cpu")
    assert ck["itrj"] == 3 and "torch_rng_state" in ck
    plaq_b = run_lqcd_params(_params(b, 6, **kw), device="cpu", history=hist_b,
                             resume_checkpoint=str(b / "checkpoint.npz"))
    # the resumed run appends to the stopped run's series and measures itrj 3 only once
    for name in ("Plaquette.txt", "Chiral_condensate.txt"):
        series = (b / "measure" / name).read_text()
        assert series == (a / "measure" / name).read_text()
        assert [line.split()[0] for line in series.splitlines() if not line.startswith("#")] \
            == [str(i) for i in range(7)]
    assert [r["itrj"] for r in hist_b] == [1, 2, 3, 4, 5, 6]
    assert sum(r["accepted"] for r in hist_a) >= 4  # the links moved
    assert plaq_a == plaq_b
    assert [r["dH"] for r in hist_a] == [r["dH"] for r in hist_b]
    for itrj in (4, 5, 6):
        _same_bits(np.load(a / f"conf_{itrj:08d}.npz")["u"], np.load(b / f"conf_{itrj:08d}.npz")["u"])
    ca, cb = np.load(a / "checkpoint.npz"), np.load(b / "checkpoint.npz")
    assert sorted(ca.files) == ["itrj", "torch_rng_state", "u"]
    for k in ca.files:
        _same_bits(ca[k], cb[k])


@pytest.mark.parametrize("fmt", list(EXT))
def test_run_saves_every_format_after_the_update(tmp_path, fmt):
    """conf_<itrj> every saveU_every trajectories, holding the links that the
    measurements of that itrj see, readable by the JAX package bit for bit."""
    hist = []
    run_lqcd_params(_params(tmp_path, 4, fmt=fmt, every=2, **ACTIONS["quenched SU(3)"]),
                    device="cpu", history=hist)
    names = sorted(f for f in os.listdir(tmp_path) if f.startswith("conf_"))
    assert names == [f"conf_00000002.{EXT[fmt]}", f"conf_00000004.{EXT[fmt]}"]
    assert [r["save_seconds"] is not None for r in hist] == [False, True, False, True]
    plaq = (tmp_path / "measure" / "Plaquette.txt").read_text().splitlines()
    for itrj in (2, 4):
        fn = tmp_path / f"conf_{itrj:08d}.{EXT[fmt]}"
        if fmt == "NPZ":
            u = tio.load_u(fn, device="cpu")
            uj = jio.load_u(fn)
        else:
            load = {"ILDG": "load_ildg", "BridgeText": "load_bridge_text", "JLD": "load_jld2"}[fmt]
            u = getattr(tio, load)(fn, LAT, 3, device="cpu")
            uj = getattr(jio, load)(fn, LAT, 3)
        _same_bits(to_numpy(u), np.asarray(uj))
        assert plaq[itrj].split()[:2] == [str(itrj), repr(float(tga.mean_plaquette(u)))]
    ck = jio.load_checkpoint(tmp_path / "checkpoint.npz")
    assert ck["itrj"] == 4 and "rng_key" not in ck


def test_savedata_refuses_an_unknown_format_and_skips_fileloading(tmp_path):
    vp = VerbosePrint(level=0)
    with pytest.raises(ValueError, match="saveU_format 'XYZ' is not supported"):
        Savedata("XYZ", str(tmp_path), 1, "HMC", vp)
    u = torch.eye(3, dtype=torch.complex128).expand((4,) + LAT + (3, 3))
    assert Savedata("NPZ", str(tmp_path), 1, "Fileloading", vp).save(u, 1) is None
    assert Savedata(None, str(tmp_path), 1, "HMC", vp).save(u, 1) is None
    assert os.listdir(tmp_path) == []


def test_port_checkpoint_loads_in_the_jax_package(tmp_path):
    u = np.asarray(jfields.hot_start(LAT, 3, seed=2))
    state = torch.Generator().manual_seed(3).get_state()
    fn = tmp_path / "checkpoint.npz"
    tio.save_checkpoint(fn, to_torch(u), rng_state=state, itrj=7, extra={"nacc": 5})
    ck = jio.load_checkpoint(fn)
    assert sorted(ck) == ["itrj", "nacc", "u"]
    assert ck["itrj"] == 7 and int(ck["nacc"]) == 5
    _same_bits(np.asarray(ck["u"]), u)
    mine = tio.load_checkpoint(fn, device="cpu")
    assert sorted(mine) == ["itrj", "nacc", "torch_rng_state", "u"]
    assert torch.equal(mine["torch_rng_state"], state)


def test_jax_checkpoint_loads_in_the_port_and_restarts_the_draws(tmp_path, capsys):
    u = jfields.cold_start(LAT, 3)
    fn = tmp_path / "checkpoint.npz"
    jio.save_checkpoint(fn, u, rng_key=jax.random.PRNGKey(4), itrj=3, extra={"nacc": 2})
    ck = tio.load_checkpoint(fn, device="cpu")
    assert sorted(ck) == ["itrj", "nacc", "rng_key", "u"] and ck["itrj"] == 3
    _same_bits(to_numpy(ck["u"]), np.asarray(u))
    hist = []
    p = _params(tmp_path / "run", 5, **ACTIONS["quenched SU(3)"])
    os.makedirs(p.saveU_dir)
    run_lqcd_params(p, device="cpu", history=hist, resume_checkpoint=str(fn))
    out = capsys.readouterr().out
    assert "holds no torch generator state" in out and "restart from randomseed = 9" in out
    assert [r["itrj"] for r in hist] == [4, 5]
    # the draws restart from randomseed: trajectory 4 is a fresh run's trajectory 1
    fresh = []
    run_lqcd_params(_params(tmp_path / "run", 1, fmt=None, **ACTIONS["quenched SU(3)"]),
                    device="cpu", history=fresh)
    assert hist[0]["dH"] == fresh[0]["dH"]


def test_cli_resume(tmp_path):
    toml = tmp_path / "run.toml"
    body = ('["Physical setting"]\nL = [4, 4, 4, 4]\n"β" = 6.0\ninitial = "cold"\nNsteps = {n}\n'
            '["HMC related"]\n"Δτ" = 0.1\nMDsteps = 3\n'
            '["System Control"]\nverboselevel = 1\nsaveU_format = "ILDG"\nsaveU_dir = "confs"\n'
            'randomseed = 4\n')
    env = dict(os.environ, PYTHONPATH=ROOT)
    finals = []
    for n, extra in ((2, []), (3, ["--resume", "confs/checkpoint.npz"])):
        toml.write_text(body.format(n=n))
        out = subprocess.run([sys.executable, "-m", "latticeqcd_torch.run", str(toml), "--device",
                              "cpu", *extra], cwd=tmp_path, env=env, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        finals.append(out.stdout)
    assert "# itrj = 1" not in finals[1] and "# itrj = 3" in finals[1]
    assert sorted(os.listdir(tmp_path / "confs")) == [
        "checkpoint.npz", "conf_00000001.ildg", "conf_00000002.ildg", "conf_00000003.ildg"]
    u3 = tio.load_ildg(tmp_path / "confs" / "conf_00000003.ildg", LAT, 3, device="cpu")
    plaq = float(finals[1].split("final plaquette = ")[1].split()[0])
    assert plaq == float(tga.mean_plaquette(u3))
