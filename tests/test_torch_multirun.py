"""Two processes of ``python -m latticeqcd_torch.multirun`` (the counterpart of
tests/test_distributed.py, with its TOML): a gloo group on the grid (1, 1, 1, 2)
on the CPU against one process of the same command. The final plaquette
agrees to 1e-12, the saved configurations agree, and only rank 0 prints the
run's output and writes the measurement and configuration files. A heatbath
TOML with overrelaxation, a stout-smeared Wilson HMC TOML and a quenched
SLMC TOML run the same command under torchrun (the env:// variables)
against one process: the same history (beta_eff included), final links,
plaquette and generator state on every rank.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120

TOML = """
["Physical setting"]
L = [4, 4, 4, 4]
NC = 2
"β" = 1.9
update_method = "HMC"
quench = true
Nsteps = 2
Nthermalization = 0
randomseed = 111
initial = "hot"
verboselevel = 2

["System Control"]
logfile = "run.log"
log_dir = "{d}/logs"
saveU_format = "NPZ"
saveU_every = 1
saveU_dir = "{d}/saves"
measurement_basedir = "{d}/meas"
measurement_dir = "dist"

["HMC related"]
MDsteps = 4
"Δτ" = 0.25

["Measurement set"]
measurement_methods = [
  {{ methodname = "Plaquette", measure_every = 1 }},
  {{ methodname = "Polyakov_loop", measure_every = 1 }},
]
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _toml(tmp_path, tag):
    d = tmp_path / tag
    for sub in ("logs", "saves", "meas"):
        (d / sub).mkdir(parents=True)
    toml = d / "params.toml"
    toml.write_text(TOML.format(d=d))
    return d, toml


def _run(args):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    return subprocess.Popen([sys.executable, "-m", "latticeqcd_torch.multirun", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=ROOT,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multirun")
    d2, toml2 = _toml(tmp, "twoproc")
    port = _free_port()
    procs = [_run([str(toml2), "1", "1", "1", "2", "--coordinator", f"127.0.0.1:{port}",
                   "--nprocs", "2", "--procid", str(rank), "--backend", "gloo",
                   "--device", "cpu"]) for rank in (0, 1)]
    d1, toml1 = _toml(tmp, "oneproc")
    procs.append(_run([str(toml1), "--device", "cpu"]))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"{p.args}\n{out}\n{err[-4000:]}"
    return (d2, outs[0][0], outs[1][0]), (d1, outs[2][0])


def _plaq(out):
    return float(out.split("final plaquette =")[1].split()[0])


def test_two_processes_match_one(runs):
    (d2, out0, _), (d1, out1) = runs
    assert "# process grid (1, 1, 1, 2) over 2 process(es), backend gloo" in out0
    assert abs(_plaq(out0) - _plaq(out1)) < 1e-12
    for name in ("conf_00000001.npz", "conf_00000002.npz"):
        a = np.load(d2 / "saves" / name)["u"]
        b = np.load(d1 / "saves" / name)["u"]
        assert a.shape == (4, 4, 4, 4, 4, 2, 2)
        assert np.abs(a - b).max() < 1e-12, name
    for name in ("Plaquette.txt", "Polyakov_loop.txt"):
        two = (d2 / "meas" / "dist" / name).read_text().splitlines()
        one = (d1 / "meas" / "dist" / name).read_text().splitlines()
        assert [line.split()[0] for line in two] == ["0", "1", "2"]
        for a, b in zip(two, one):
            assert np.allclose([float(v) for v in a.split()[1:-2]],
                               [float(v) for v in b.split()[1:-2]], rtol=0, atol=1e-12)


def test_only_rank0_prints_and_writes(runs):
    (d2, out0, out_rank1), _ = runs
    assert "final plaquette =" in out0 and "# itrj = 2" in out0
    assert "final plaquette =" not in out_rank1 and "itrj" not in out_rank1
    assert out_rank1.strip() == ""
    # both ranks share the directory: exactly one series of files, written once
    assert sorted(os.listdir(d2 / "saves")) == ["checkpoint.npz", "conf_00000001.npz",
                                                "conf_00000002.npz"]
    log = (d2 / "logs" / "run.log").read_text()
    assert log.count("# itrj = 1") == 1 and "Acceptance" in log


def test_multirun_runs_on_the_card_unless_told(tmp_path, monkeypatch):
    """Without --device the run is on cuda:<local rank>: here, with no card, it fails
    rather than move to the CPU; with two processes and no --backend it refuses."""
    import torch

    from latticeqcd_torch import multirun

    _, toml = _toml(tmp_path, "nocard")
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|cuda"):
        multirun.main([str(toml)])
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert multirun.main([str(toml), "1", "1", "1", "2"]) == 2


def _case_resume(grid, workdir):
    """Under the grid: 3 quenched trajectories straight, and 2 then a resumed third from
    the checkpoint; returns both runs' final plaquettes and this rank's final links."""
    import torch

    from latticeqcd_torch.system.lqcd import run_lqcd_params
    from latticeqcd_torch.system.params import Params

    out = {}
    for tag, nsteps, resume in (("straight", 3, None), ("first", 2, None),
                                ("resumed", 3, os.path.join(workdir, "first", "checkpoint.npz"))):
        save = os.path.join(workdir, tag)
        os.makedirs(save, exist_ok=True)
        p = Params(L=(4, 4, 4, 4), NC=2, beta=1.9, update_method="HMC", quench=True,
                   initial="hot", randomseed=111, Nsteps=nsteps, MDsteps=4, dtau=0.25,
                   verboselevel=0, saveU_format="NPZ", saveU_every=1, saveU_dir=save)
        final = {}
        out[f"{tag}_plaq"] = np.asarray(run_lqcd_params(
            p, make_dirs=False, device="cpu", grid=grid, resume_checkpoint=resume,
            final=final))
        out[f"{tag}_u"] = final["u"].numpy()
        torch.distributed.barrier()
    return out


@pytest.mark.parametrize("pes", [(1, 1, 1, 2), (2, 1, 1, 2)], ids=["t2", "x2t2"])
def test_resume_under_a_grid_is_bitwise(tmp_path, pes):
    """A sharded run resumed from its checkpoint (read by every rank, each keeping its
    block) ends where the run that was never stopped ends, bit for bit."""
    from test_torch_grid import run_ranks

    (tmp_path / "out").mkdir()
    ranks = run_ranks("test_torch_multirun", "resume", pes, tmp_path / "out", tmp_path)
    for res in ranks:
        assert res["straight_plaq"].tobytes() == res["resumed_plaq"].tobytes()
        assert res["straight_u"].tobytes() == res["resumed_u"].tobytes()
    assert sorted(os.listdir(tmp_path / "resumed")) == ["checkpoint.npz", "conf_00000003.npz"]


def _rank_main(argv):
    from test_torch_grid import rank_main

    rank_main(argv, {"resume": _case_resume}, lattice=(4, 4, 4, 4))


HEATBATH_TOML = """
["Physical setting"]
L = [4, 4, 4, 8]
NC = 3
"β" = 6.0
update_method = "Heatbath"
quench = true
useOR = true
numOR = 2
Nsteps = 2
Nthermalization = 0
randomseed = 113
initial = "hot"
verboselevel = 1

["Measurement set"]
measurement_basedir = "{d}/meas"
measurement_dir = "hb"
measurement_methods = [
  {{ methodname = "Plaquette", measure_every = 1 }},
]
"""


def _torchrun_against_one(tmp_path, text, bitwise):
    """torchrun starts two ranks of multirun on the TOML ``text`` over a lattice whose t
    extent the grid (1, 1, 1, 2) halves, beside one process of the same command: every
    rank's report holds the one-process run's history (dH, decisions, beta_eff; the same
    bit for bit on every rank), its plaquette and its generator state, and the blocks of
    its final links (bit for bit if ``bitwise``, else to 1e-12)."""
    reports = {}
    procs = []
    for tag, launcher in (("torchrun", ["-m", "torch.distributed.run", "--nnodes", "1",
                                        "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
                                        "--master_port", str(_free_port()), "-m",
                                        "latticeqcd_torch.multirun"]),
                          ("one", ["-m", "latticeqcd_torch.multirun"])):
        d = tmp_path / tag
        (d / "meas").mkdir(parents=True)
        toml = d / "params.toml"
        toml.write_text(text.format(d=d))
        args = [str(toml)] + (["1", "1", "1", "2", "--backend", "gloo"] if tag == "torchrun"
                              else []) + ["--device", "cpu", "--report", str(d / "report")]
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
        procs.append(subprocess.Popen([sys.executable, *launcher, *args], stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, env=env, cwd=ROOT, text=True))
        reports[tag] = d / "report"
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"{p.args}\n{out}\n{err[-4000:]}"
    import json

    one = json.loads((reports["one"] / "rank0.json").read_text())
    u_one = np.load(reports["one"] / "rank0_u.npy")
    nt = u_one.shape[4] // 2
    keys = ("itrj", "dH", "accepted", "beta_eff")
    history = lambda rep: [[r[k] for k in keys] for r in rep["history"]]  # noqa: E731
    first = None
    for rank in (0, 1):
        rep = json.loads((reports["torchrun"] / f"rank{rank}.json").read_text())
        assert rep["nprocs"] == 2 and rep["pes"] == [1, 1, 1, 2]
        assert abs(rep["plaquette"] - one["plaquette"]) < 1e-12
        assert rep["generator_sha256"] == one["generator_sha256"]
        for got, want in zip(history(rep), history(one)):
            assert got[0] == want[0] and got[2] == want[2]
            for a, b in zip(got[1:2] + list(got[3] or ()), want[1:2] + list(want[3] or ())):
                assert a is None and b is None or abs(a - b) < 1e-12 * max(1.0, abs(b))
        first = first or history(rep)
        assert history(rep) == first
        block = np.load(reports["torchrun"] / f"rank{rank}_u.npy")
        want = u_one[:, :, :, :, nt * rank:nt * (rank + 1)]
        if bitwise:
            assert block.tobytes() == want.tobytes()
        else:
            assert np.abs(block - want).max() < 1e-12
    return one


def test_heatbath_toml_under_torchrun_matches_one_process(tmp_path):
    """torchrun starts two ranks of multirun on a heatbath TOML (quenched SU(3) with 2
    overrelaxations per sweep): every rank's report holds the plaquette and the generator
    state of the one-process run, and the blocks of its final links, bit for bit."""
    one = _torchrun_against_one(tmp_path, HEATBATH_TOML, bitwise=True)
    assert [r["itrj"] for r in one["history"]] == [1, 2]


STOUT_TOML = """
["Physical setting"]
L = [4, 4, 2, 4]
NC = 3
"β" = 5.7
update_method = "HMC"
Nsteps = 1
randomseed = 117
initial = "hot"
verboselevel = 1

["Physical setting(fermions)"]
quench = false
Dirac_operator = "Wilson"
hop = 0.13
eps = 1e-22
smearing_for_fermion = "stout"
stout_numlayers = 2
stout_rho = [0.1]

["HMC related"]
MDsteps = 2
"Δτ" = 0.05
"""

SLMC_TOML = """
["Physical setting"]
L = [4, 4, 2, 4]
NC = 3
"β" = 6.0
update_method = "SLMC"
quench = true
"βeff" = 5.5
firstlearn = 1
Nsteps = 3
randomseed = 119
initial = "hot"
verboselevel = 2
"""


@pytest.mark.parametrize("text", [STOUT_TOML, SLMC_TOML], ids=["stout", "SLMC"])
def test_toml_under_torchrun_matches_one_process(tmp_path, text):
    """A TOML of stout-smeared two-flavour Wilson HMC (2 layers) and one of quenched SLMC
    (learning from its first step) under torchrun: the one-process run's history, beta_eff
    included, plaquette, generator state and links (to 1e-12: the global sums of the
    grid round in another order) on every rank."""
    one = _torchrun_against_one(tmp_path, text, bitwise=False)
    assert all(r["dH"] is not None for r in one["history"])
    if "SLMC" in text:
        assert one["history"][-1]["beta_eff"][0] != 5.5
