"""Port parity: configurations on disk.

Every format (NPZ, ILDG, Bridge++ text, JLD2) round-trips bit for bit in
both directions between the JAX package and the port, ILDG and Bridge++
text files of the same field are byte-identical, the Fileloading
updater lists and loads the same configurations, a Fileloading run
writes the same measurement lines (Z4 noise injected as the integers JAX
draws), and a run starts from a file in every format. All at 4^4.
"""

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu import io as jio  # noqa: E402
from latticeqcd_tpu.io import ildg as jildg  # noqa: E402
from latticeqcd_tpu.measurements import fermionic as jferm  # noqa: E402
from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops.dirac import staggered as js  # noqa: E402
from latticeqcd_tpu.system import lqcd as jlqcd  # noqa: E402
from latticeqcd_tpu.system.params import Params as JParams  # noqa: E402
from latticeqcd_tpu.updates.fileloading import GivenConfigurations as JGiven  # noqa: E402
from latticeqcd_torch import _nvcc, convert  # noqa: E402
from latticeqcd_torch import io as tio  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.io import ildg as tildg  # noqa: E402
from latticeqcd_torch.io import jld2 as tjld2  # noqa: E402
from latticeqcd_torch.io import native_ext as text  # noqa: E402
from latticeqcd_torch.measurements import fermionic as tferm  # noqa: E402
from latticeqcd_torch.ops import gauge_action as tga  # noqa: E402
from latticeqcd_torch.ops.dirac import staggered as ts  # noqa: E402
from latticeqcd_torch.system.lqcd import run_lqcd_params  # noqa: E402
from latticeqcd_torch.system.params import Params as TParams  # noqa: E402
from latticeqcd_torch.updates.fileloading import GivenConfigurations as TGiven  # noqa: E402
from test_torch_measurements import _z4_draws  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXT = {"NPZ": "npz", "ILDG": "ildg", "BridgeText": "txt", "JLD": "jld2"}
DTYPES = ("complex64", "complex128")


def _field(nc, dtype="complex128", seed=3, lat=LAT) -> np.ndarray:
    return np.asarray(jfields.hot_start(lat, nc, seed=seed, dtype=jnp.complex128)).astype(dtype)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _save(io, fmt, fn, u):
    {"NPZ": io.save_u, "ILDG": io.save_ildg, "BridgeText": io.save_bridge_text,
     "JLD": io.save_jld2}[fmt](fn, u)


def _load_jax(fmt, fn, lat, nc, dtype) -> np.ndarray:
    dt = jnp.dtype(dtype)
    if fmt == "NPZ":
        return np.asarray(jio.load_u(fn, dtype=dt))
    load = {"ILDG": jio.load_ildg, "BridgeText": jio.load_bridge_text, "JLD": jio.load_jld2}[fmt]
    return np.asarray(load(fn, lat, nc, dtype=dt))


def _load_torch(fmt, fn, lat, nc, dtype) -> np.ndarray:
    kw = dict(dtype=getattr(torch, dtype), device="cpu")
    if fmt == "NPZ":
        return to_numpy(tio.load_u(fn, **kw))
    load = {"ILDG": tio.load_ildg, "BridgeText": tio.load_bridge_text, "JLD": tio.load_jld2}[fmt]
    return to_numpy(load(fn, lat, nc, **kw))


# ------------------------------------------------------- formats, both ways

CASES = [(fmt, nc, dt) for fmt in EXT for nc in (2, 3) for dt in DTYPES]


@pytest.mark.parametrize("fmt,nc,dtype", CASES)
def test_jax_save_loads_in_the_port_bit_for_bit(tmp_path, fmt, nc, dtype):
    u = _field(nc, dtype)
    fn = tmp_path / f"conf.{EXT[fmt]}"
    _save(jio, fmt, fn, jnp.asarray(u))
    got = _load_torch(fmt, fn, LAT, nc, dtype)
    _same_bits(got, u)
    _same_bits(got, _load_jax(fmt, fn, LAT, nc, dtype))


@pytest.mark.parametrize("fmt,nc,dtype", CASES)
def test_port_save_loads_in_jax_bit_for_bit(tmp_path, fmt, nc, dtype):
    u = _field(nc, dtype, seed=4)
    fn = tmp_path / f"conf.{EXT[fmt]}"
    _save(tio, fmt, fn, to_torch(u))
    _same_bits(_load_jax(fmt, fn, LAT, nc, dtype), u)
    _same_bits(_load_torch(fmt, fn, LAT, nc, dtype), u)


@pytest.mark.parametrize("fmt,nc,dtype", [c for c in CASES if c[0] in ("ILDG", "BridgeText")])
def test_both_packages_write_the_same_bytes(tmp_path, fmt, nc, dtype):
    u = _field(nc, dtype, seed=5)
    a, b = tmp_path / f"jax.{EXT[fmt]}", tmp_path / f"torch.{EXT[fmt]}"
    _save(jio, fmt, a, jnp.asarray(u))
    _save(tio, fmt, b, to_torch(u))
    assert a.read_bytes() == b.read_bytes()


# ------------------------------------------------------------------ ILDG


def test_ildg_multiconfig_append_and_index(tmp_path):
    confs = [_field(3, seed=s) for s in (6, 7, 8)]
    a, b = tmp_path / "jax.ildg", tmp_path / "torch.ildg"
    for u in confs:
        jio.save_ildg(a, jnp.asarray(u), append=True)
        tio.save_ildg(b, to_torch(u), append=True)
    assert a.read_bytes() == b.read_bytes()
    handle = tildg.ILDG(b)
    assert len(handle) == len(jildg.ILDG(b)) == 3
    for i, u in enumerate(confs, start=1):
        _same_bits(to_numpy(handle.load(i, LAT, 3, device="cpu")), u)
        _same_bits(to_numpy(tio.load_ildg(b, LAT, 3, index=i, device="cpu")), u)
    with pytest.raises(IndexError):
        handle.load(4, LAT, 3, device="cpu")
    # without append a save starts the file anew
    tio.save_ildg(b, to_torch(confs[0]))
    assert len(tildg.ILDG(b)) == 1


def _file_order(u):
    """Interleaved re/im of U in the ILDG / Bridge++ order (t slowest)."""
    flat = np.transpose(u, (4, 3, 2, 1, 0, 5, 6)).reshape(-1)
    out = np.empty(2 * flat.size)
    out[0::2], out[1::2] = flat.real, flat.imag
    return out


@pytest.mark.parametrize("precision", [64, 32])
def test_ildg_headerless_blob(tmp_path, precision):
    u = _field(3, seed=9)
    fn = tmp_path / "conf.bin"
    fn.write_bytes(_file_order(u).astype(">f8" if precision == 64 else ">f4").tobytes())
    got = to_numpy(tildg.load_binary(fn, LAT, 3, device="cpu"))
    _same_bits(got, np.asarray(jildg.load_binary(fn, LAT, 3)))
    want = u if precision == 64 else u.astype(np.complex64).astype(np.complex128)
    _same_bits(got, want)


def test_ildg_32bit_payload(tmp_path):
    u = _field(3, seed=10)
    xml = (b"<?xml version=\"1.0\"?><ildgFormat><field>su3gauge</field>"
           b"<precision>32</precision><lx>4</lx><ly>4</ly><lz>4</lz><lt>4</lt></ildgFormat>")
    payload = _file_order(u).astype(">f4").tobytes()
    fn = tmp_path / "conf32.ildg"
    fn.write_bytes(tildg._lime_record(b"ildg-format", xml, first=True)
                   + tildg._lime_record(b"ildg-binary-data", payload, last=True))
    got = to_numpy(tio.load_ildg(fn, LAT, 3, device="cpu"))
    _same_bits(got, np.asarray(jio.load_ildg(fn, LAT, 3)))
    _same_bits(got, u.astype(np.complex64).astype(np.complex128))


@pytest.mark.parametrize("fmt", ["ILDG", "BridgeText", "JLD"])
def test_wrong_lattice_raises_value_error(tmp_path, fmt):
    fn = tmp_path / f"conf.{EXT[fmt]}"
    _save(tio, fmt, fn, to_torch(_field(3)))
    for load in (_load_torch, _load_jax):
        with pytest.raises(ValueError):
            load(fmt, fn, (4, 4, 4, 2), 3, "complex128")


def test_jld2_without_h5py_raises_a_clear_error(tmp_path, monkeypatch):
    fn = tmp_path / "conf.jld2"
    tio.save_jld2(fn, to_torch(_field(3)))
    monkeypatch.setattr(tjld2, "h5py", None)
    monkeypatch.setattr(tjld2, "_H5PY_ERR", ImportError("No module named 'h5py'"))
    with pytest.raises(ImportError, match="JLD2 I/O needs h5py"):
        tio.load_jld2(fn, LAT, 3, device="cpu")
    with pytest.raises(ImportError, match="JLD2 I/O needs h5py"):
        tio.save_jld2(tmp_path / "other.jld2", to_torch(_field(3)))
    p = TParams(L=LAT, NC=3, initial=str(fn), loadU_format="JLD", quench=True, Nsteps=0,
                verboselevel=1)
    with pytest.raises(ImportError, match="JLD2 I/O needs h5py"):
        run_lqcd_params(p, device="cpu")


# ------------------------------------------------------------ fast text I/O


def test_fastio_matches_the_numpy_path(tmp_path, monkeypatch):
    u = _field(3, seed=11)
    fn = tmp_path / "conf.txt"
    tio.save_bridge_text(fn, to_torch(u))
    n = 2 * u.size
    assert text._load() is not None
    assert text.library_path().parent == _nvcc.BUILD and text.library_path().exists()
    fast = text.parse_text_doubles(fn, n)
    cfast = text.to_complex(fast)
    monkeypatch.setattr(text, "_load", lambda: None)
    slow = text.parse_text_doubles(fn, n)
    _same_bits(fast, slow)
    _same_bits(cfast, text.to_complex(slow))
    _same_bits(fast, _file_order(u))


def test_fastio_build_failure_warns_and_falls_back(tmp_path, monkeypatch):
    broken = tmp_path / "fastio.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(text, "_SRC", broken)
    monkeypatch.setattr(text, "_TRIED", False)
    monkeypatch.setattr(text, "_LIB", None)
    monkeypatch.setattr(_nvcc, "BUILD", tmp_path / "build")
    with pytest.warns(UserWarning, match="fastio build failed"):
        assert text._load() is None
    u = _field(3, seed=12)
    fn = tmp_path / "conf.txt"
    tio.save_bridge_text(fn, to_torch(u))
    _same_bits(to_numpy(tio.load_bridge_text(fn, LAT, 3, device="cpu")), u)


# ------------------------------------------------------------ Fileloading


def _stored(tmp_path, fmt, n=3, extra=()):
    d = tmp_path / f"confs_{fmt}"
    d.mkdir()
    confs = [_field(3, seed=20 + i) for i in range(n)]
    for i, u in enumerate(confs, start=1):
        _save(tio, fmt, d / f"conf_{i:08d}.{EXT[fmt]}", to_torch(u))
    for name in extra:
        (d / name).write_text("not a configuration\n")
    return d, confs


def _same_list(p):
    jg, tg = JGiven.from_params(p, LAT, 3), TGiven.from_params(p, LAT, 3)
    assert jg.filelist == tg.filelist and jg.nsteps == tg.Nsteps
    u0 = torch.zeros((4,) + LAT + (3, 3), dtype=torch.complex128)
    loaded = []
    for _ in range(tg.Nsteps):
        ut, st = tg.step(u0, None)
        uj, _, acc = jg.update(jnp.zeros(u0.shape, jnp.complex128), None)
        assert st["accepted"] and acc
        _same_bits(to_numpy(ut), np.asarray(uj))
        loaded.append(to_numpy(ut))
    return tg, loaded


@pytest.mark.parametrize("fmt", list(EXT))
def test_given_configurations_list_the_same_files(tmp_path, fmt):
    d, confs = _stored(tmp_path, fmt, extra=("notes.md",))
    if fmt == "JLD":  # a JLD directory also takes .npz files
        tio.save_u(d / "conf_00000009.npz", to_torch(confs[0]))
        confs = confs + [confs[0]]
    tg, loaded = _same_list(JParams(L=LAT, update_method="Fileloading", loadU_format=fmt,
                                    loadU_dir=str(d)))
    assert tg.Nsteps == len(confs)
    for got, u in zip(loaded, confs):
        _same_bits(got, u)


def test_given_configurations_list_file(tmp_path):
    d, confs = _stored(tmp_path, "BridgeText")
    (d / "list.txt").write_text("# chosen\nconf_00000003.txt\n\nconf_00000001.txt extra words\n")
    tg, loaded = _same_list(JParams(L=LAT, update_method="Fileloading", loadU_format="BridgeText",
                                    loadU_dir=str(d), loadU_fromfile=True,
                                    loadU_filename="list.txt"))
    assert [os.path.basename(f) for f in tg.filelist] == ["conf_00000003.txt", "conf_00000001.txt"]
    _same_bits(loaded[0], confs[2])
    _same_bits(loaded[1], confs[0])


def test_given_configurations_expand_a_multiconfig_ildg(tmp_path):
    d, confs = _stored(tmp_path, "ILDG", n=1)
    multi = [_field(3, seed=30 + i) for i in range(3)]
    for u in multi:
        tio.save_ildg(d / "multi.ildg", to_torch(u), append=True)
    tg, loaded = _same_list(JParams(L=LAT, update_method="Fileloading", loadU_format="ILDG",
                                    loadU_dir=str(d)))
    assert tg.filelist[0].endswith("conf_00000001.ildg")
    assert [e[1] for e in tg.filelist[1:]] == [1, 2, 3]
    for got, u in zip(loaded, confs + multi):
        _same_bits(got, u)


def test_given_configurations_refuse_an_unknown_format_and_an_empty_dir(tmp_path):
    for cls in (JGiven, TGiven):
        with pytest.raises(ValueError, match="loadU_format"):
            cls.from_params(JParams(loadU_format="XYZ", loadU_dir=str(tmp_path)), LAT, 3)
        with pytest.raises(FileNotFoundError):
            cls.from_params(JParams(loadU_format="ILDG", loadU_dir=str(tmp_path)), LAT, 3)


def _inject_z4(monkeypatch, noise_seed, itrjs, nspin, nr, lattice=LAT):
    """The port's Z4 noise, call by call, replaced by the integers that JAX draws
    from PRNGKey(noise_seed + itrj) for each measured itrj in turn."""
    draws = iter([d for i in itrjs
                  for d in _z4_draws(jax.random.PRNGKey(noise_seed + i), lattice, 3, nspin, nr)])
    z4 = tferm.z4_spinor
    monkeypatch.setattr(tferm, "z4_spinor",
                        lambda *a, **kw: z4(*a, **dict(kw, generator=None, draws=next(draws))))


def _numbers(line):
    body = line[1:] if line.startswith("#") else line
    return [float(x) for x in body.split("#")[0].split()]


def test_fileloading_run_matches_jax_line_for_line(tmp_path, monkeypatch):
    d, _ = _stored(tmp_path, "ILDG")
    methods = [
        {"methodname": "Plaquette"}, {"methodname": "Polyakov_loop"},
        {"methodname": "Chiral_condensate", "Nr": 2, "eps": 1e-28, "MaxCGstep": 500,
         "noise_seed": 7, "fermion_parameters": {"Dirac_operator": "Wilson", "hop": 0.12}},
    ]
    kw = dict(L=LAT, NC=3, beta=6.0, update_method="Fileloading", loadU_format="ILDG",
              loadU_dir=str(d), verboselevel=1, measurement_methods=methods)
    jlqcd.run_lqcd_params(JParams(**kw, measuredir=str(tmp_path / "jax")))
    _inject_z4(monkeypatch, 7, range(4), nspin=4, nr=2)
    history = []
    run_lqcd_params(TParams(**kw, measuredir=str(tmp_path / "torch")), dtype=torch.complex128,
                    device="cpu", history=history)
    assert [r["itrj"] for r in history] == [1, 2, 3]
    assert all(r["accepted"] and r["dH"] is None and r["save_seconds"] is None for r in history)
    for name in ("Plaquette", "Polyakov_loop", "Chiral_condensate"):
        lj = (tmp_path / "jax" / f"{name}.txt").read_text().splitlines()
        lt = (tmp_path / "torch" / f"{name}.txt").read_text().splitlines()
        assert len(lj) == len(lt) >= 4
        for a, b in zip(lj, lt):
            assert a.split("#")[-1] == b.split("#")[-1]
            np.testing.assert_allclose(_numbers(b), _numbers(a), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("fmt", list(EXT))
def test_file_start(tmp_path, fmt, capsys):
    u = _field(3, seed=40)
    fn = tmp_path / f"start.{EXT[fmt]}"
    _save(tio, fmt, fn, to_torch(u))
    kw = dict(L=LAT, NC=3, beta=6.0, initial=str(fn), loadU_format=fmt, quench=True, Nsteps=0,
              verboselevel=2, measurement_methods=[{"methodname": "Plaquette"}])
    plaq = run_lqcd_params(TParams(**kw, measuredir=str(tmp_path / "torch")), device="cpu")
    out = capsys.readouterr().out
    assert ".....  File start" in out and f"File name is {fn}" in out
    assert plaq == float(tga.mean_plaquette(to_torch(u)))
    jplaq = jlqcd.run_lqcd_params(JParams(**kw, measuredir=str(tmp_path / "jax")))
    assert abs(plaq - jplaq) < 1e-14
    assert (tmp_path / "torch" / "Plaquette.txt").read_text().split()[1] == repr(plaq)


@pytest.mark.parametrize("fmt", [None, "XYZ"])
def test_file_start_needs_a_known_format(tmp_path, fmt):
    kw = dict(L=LAT, NC=3, initial=str(tmp_path / "start.bin"), loadU_format=fmt, quench=True,
              Nsteps=0, verboselevel=1)
    with pytest.raises(ValueError, match="loadU_format") as jerr:
        jlqcd.run_lqcd_params(JParams(**kw))
    with pytest.raises(ValueError, match="loadU_format") as terr:
        run_lqcd_params(TParams(**kw), device="cpu")
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------------ the anchor


@pytest.mark.slow
def test_anchor_pbp_on_the_committed_chain_matches_jax():
    """The port's staggered pbp (m = 0.025, Nf = 4, Nr = 2, eps 1e-9) on the
    JAX chain's thermalised beta = 5.6 state against the JAX package's, from
    the same Z4 draws, to 1e-5."""
    lat = (12, 12, 12, 8)
    with np.load(os.path.join(ROOT, "PERF_CAPTURE", "pbp56_ckpt.npz")) as z:
        u = z["u"]
    assert u.shape == (4,) + lat + (3, 3) and u.dtype == np.complex64
    key = jax.random.PRNGKey(5)
    jp, jv = jferm.chiral_condensate(jnp.asarray(u), js.StaggeredDirac(mass=0.025, lattice=lat),
                                     key, nr=2, nf_factor=1.0, eps=1e-9, maxiter=4000)
    tp, tv = tferm.chiral_condensate(to_torch(u), ts.StaggeredDirac(mass=0.025, lattice=lat),
                                     nr=2, nf_factor=1.0, eps=1e-9, maxiter=4000,
                                     draws=_z4_draws(key, lat, 3, 1, 2))
    assert abs(tp - float(jp)) < 1e-5 * abs(float(jp))
    np.testing.assert_allclose(tv, np.asarray(jv, dtype=np.float64), rtol=1e-5)


@pytest.mark.parametrize("field,value,item", [
    ("update_method", "SLHMC", "A12"), ("update_method", "SLMC", "A12"),
    ("update_method", "IntegratedHMC", "A12"), ("update_method", "IntegratedHB", "A12"),
])
def test_instanton_start_and_other_updaters_are_still_refused(field, value, item):
    # ported: the self-learning and integrated updaters run (quenched here; the
    # parity against the JAX package is in test_torch_slhmc.py and test_torch_slmc.py)
    history = []
    p = TParams(**{"L": LAT, "NC": 3, "quench": True, "Nsteps": 1, "verboselevel": 1,
                   "MDsteps": 5, "dtau": 0.02, field: value})
    plaq = run_lqcd_params(p, device="cpu", history=history)
    assert 0.0 < plaq <= 1.0 and len(history) == 1
    assert history[0]["beta_eff"] is not None and math.isfinite(history[0]["dH"])


def test_validation_pbp_reads_its_measurements_back(tmp_path, capsys):
    """validation_pbp with no trajectory: an NPZ file start from the
    committed beta = 5.6 state and its trajectory-0 pbp, read back from the
    measurement file into the JSON line."""
    import json

    from latticeqcd_torch import validation_pbp

    assert validation_pbp.main(["5.6", "--traj", "0", "--device", "cpu", "--out",
                                str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_meas"] == 1 and out["n_traj"] == 0 and out["device"] == "cpu"
    assert 0.1239 <= out["pbp"] <= 0.1467
    assert 0.575 <= out["plaq_min"] == out["plaq_max"] <= 0.589
    assert out["jax"]["pbp"] == 0.13531
    lines = (tmp_path / "beta5.6" / "Chiral_condensate.txt").read_text().splitlines()
    assert lines[-1].split()[:2] == ["0", repr(out["pbp"])]
