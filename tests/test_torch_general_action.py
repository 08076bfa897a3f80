"""Port parity: general gauge actions (ops/wilsonline.py's named loop sets and
generic staple, ops/gauge_action.py's generic branch, system/universe.py's
build_gauge_action), and the heatbath, overrelaxation and flow on them."""

import functools
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops import gauge_action as jga  # noqa: E402
from latticeqcd_tpu.ops import wilsonline as jwl  # noqa: E402
from latticeqcd_tpu.smearing import gradientflow as _jgf  # noqa: E402,F401
from latticeqcd_tpu.system import params as jparams  # noqa: E402
from latticeqcd_tpu.system import universe as juniv  # noqa: E402
from latticeqcd_tpu.updates import heatbath as jhb  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.ops import gauge_action as tga  # noqa: E402
from latticeqcd_torch.ops import sun as tsun  # noqa: E402
from latticeqcd_torch.ops import wilsonline as twl  # noqa: E402
from latticeqcd_torch.smearing import gradientflow as tgf  # noqa: E402
from latticeqcd_torch.system import params as tparams  # noqa: E402
from latticeqcd_torch.system import universe as tuniv  # noqa: E402
from latticeqcd_torch.updates import heatbath as thb  # noqa: E402
from test_torch_heatbath import JaxUniforms, warm_links  # noqa: E402

jgf = sys.modules["latticeqcd_tpu.smearing.gradientflow"]
to_torch = functools.partial(convert.to_torch, device="cpu")

LAT = (4, 4, 4, 4)
TOL = 1e-12
# Iwasaki at beta_I = 2.6 in the reference's convention: the plaquette at
# c0 beta_I, the rectangles through couplinglist at c1 beta_I
C0, C1, BETA_I = 3.648, -0.331, 2.6

# name -> Params fields of the action (both packages build it from them)
ACTIONS = {
    "iwasaki": dict(beta=C0 * BETA_I, couplinglist=["rectangular"], couplingcoeff=[C1 * BETA_I]),
    "chair": dict(beta=5.5, couplinglist=["chair"], couplingcoeff=[-0.1]),
    "polyakov_t": dict(beta=5.5, couplinglist=["polyakov_t"], couplingcoeff=[0.2]),
    "coupling_loops": dict(beta=5.5, couplingcoeff=[0.3],
                           coupling_loops=[[[(0, 1), (1, 2), (0, -1), (1, -2)]]]),
}


def _symanzik(ga, wl, nc, beta=1.9):
    """tests/test_clover_and_general_action.py's plaquette + rectangle action."""
    return ga.general_gauge_action(nc, [beta, -beta / 20.0],
                                   [wl.make_loops_fromname("plaquette", 4),
                                    wl.make_loops_fromname("rectangular", 4)])


def both_actions(name, nc):
    """(JAX action, port action) of one of ACTIONS or the Symanzik action."""
    if name == "symanzik":
        return _symanzik(jga, jwl, nc), _symanzik(tga, twl, nc)
    kw = dict(NC=nc, L=LAT, **ACTIONS[name])
    return (juniv.build_gauge_action(jparams.Params(**kw)),
            tuniv.build_gauge_action(tparams.Params(**kw)))


ALL = ["iwasaki", "symanzik", "chair", "polyakov_t", "coupling_loops"]


@pytest.mark.parametrize("name", ["plaquette", "rectangular", "chair", "polyakov_x",
                                  "polyakov_y", "polyakov_z", "polyakov_t"])
def test_loop_sets_match_jax(name):
    lat = (4, 6, 8, 10)
    ref = [l.segments for l in jwl.make_loops_fromname(name, 4, lattice=lat)]
    got = [l.segments for l in twl.make_loops_fromname(name, 4, lattice=lat)]
    assert got == ref and len(got) == {"plaquette": 6, "rectangular": 12, "chair": 24}.get(name, 1)
    if name.startswith("polyakov"):
        with pytest.raises(ValueError, match="lattice extent"):
            twl.make_loops_fromname(name)
    with pytest.raises(ValueError, match="unknown loop set"):
        twl.make_loops_fromname("hexagon")


@pytest.mark.parametrize("nc", [2, 3])
@pytest.mark.parametrize("name", ALL)
def test_staples_force_and_action_match_jax(name, nc):
    act_j, act_t = both_actions(name, nc)
    assert act_t.plaq_coeff == act_j.plaq_coeff == 0.0  # the generic path
    assert act_t.max_extent() == act_j.max_extent()
    assert [(c, [l.segments for l in ls]) for c, ls in act_t.terms] == \
        [(c, [l.segments for l in ls]) for c, ls in act_j.terms]
    u = jfields.hot_start(LAT, nc, seed=60 + nc)
    ut = to_torch(np.asarray(u))
    s_j = float(jga.action_value(act_j, u))
    assert abs(s_j - float(tga.action_value(act_t, ut))) < TOL * abs(s_j)
    for mu in range(4):
        ref = np.asarray(jga.staples(act_j, u, mu))
        assert np.abs(ref - to_numpy(tga.staples(act_t, ut, mu))).max() < TOL * max(1, abs(ref).max())
        ref = np.asarray(jga.local_heatbath_exponent_matrix(act_j, u, mu))
        assert np.abs(ref - to_numpy(tga.local_heatbath_exponent_matrix(act_t, ut, mu))).max() \
            < TOL * max(1, abs(ref).max())
    f_t = tga.force(act_t, ut)
    assert np.abs(np.asarray(jga.force(act_j, u)) - to_numpy(f_t)).max() < TOL
    # the autograd oracle: the port's against the port's force and against JAX's oracle
    f_ad = tga.force_autodiff(act_t, ut)
    assert float((f_ad - f_t).abs().max()) < 1e-10
    assert np.abs(np.asarray(jga.force_autodiff(act_j, u)) - to_numpy(f_ad)).max() < 1e-10


@pytest.mark.parametrize("nc", [2, 3])
def test_generic_plaquette_staple_matches_the_fused_one(nc):
    """The Wilson action through the generic path derivative: the same staple."""
    fused = tga.wilson_gauge_action(nc, 5.7)
    generic = tga.GaugeAction(nc, fused.terms)  # plaq_coeff 0: the generic branch
    ut = to_torch(np.asarray(jfields.hot_start(LAT, nc, seed=64)))
    for mu in range(4):
        assert float((tga.staples(generic, ut, mu) - tga.staples(fused, ut, mu)).abs().max()) < TOL
    assert float((tga.force(generic, ut) - tga.force(fused, ut)).abs().max()) < TOL


def test_build_gauge_action_keeps_the_rules():
    """push drops plaq_coeff; use_autogeneratedstaples warns and is ignored;
    the Iwasaki terms are the plaquette at beta/2 and the rectangles at c/2."""
    p = tparams.Params(NC=3, L=LAT, use_autogeneratedstaples=True, **ACTIONS["iwasaki"])
    with pytest.warns(UserWarning, match="use_autogeneratedstaples"):
        act = tuniv.build_gauge_action(p)
    assert [(c, len(ls)) for c, ls in act.terms] == [(C0 * BETA_I / 2, 12), (C1 * BETA_I / 2, 24)]
    assert act.plaq_coeff == 0.0 and act.max_extent() == 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tuniv.build_gauge_action(tparams.Params(NC=3, beta=6.0)).plaq_coeff == 3.0


# ---------------------------------------------- heatbath, overrelaxation, flow


def test_rectangle_overrelaxation_matches_jax():
    act_j, act_t = both_actions("symanzik", 2)
    u = warm_links(LAT, 2, seed=65)
    u_j, _ = jhb.Heatbath(action=act_j).overrelax(jnp.asarray(u), jax.random.PRNGKey(0))
    u_t = thb.Heatbath(action=act_t).overrelax(to_torch(u))
    assert np.abs(np.asarray(u_j) - to_numpy(u_t)).max() < TOL
    assert np.abs(u - to_numpy(u_t)).max() > 1e-3
    s0, s1 = float(tga.action_value(act_t, to_torch(u))), float(tga.action_value(act_t, u_t))
    assert abs(s1 - s0) < 1e-8 * max(1.0, abs(s0))


def test_rectangle_heatbath_sweep_matches_jax():
    act_j, act_t = both_actions("symanzik", 2)
    assert thb.color_masks(act_t, LAT).shape[0] == 4 ** 4  # modulus 4 per axis
    u = warm_links(LAT, 2, seed=66)
    key = jax.random.PRNGKey(67)
    u_j, _ = jhb.Heatbath(action=act_j).sweep(jnp.asarray(u), key)
    u_t = thb.Heatbath(action=act_t).sweep(to_torch(u), uniforms=JaxUniforms(key))
    assert np.abs(np.asarray(u_j) - to_numpy(u_t)).max() < TOL
    assert float(tsun.unitarity_defect(u_t)) < TOL


@pytest.mark.parametrize("nc", [2, 3])
def test_general_action_flow_matches_jax(nc):
    """5 flow steps of 0.02 of the Iwasaki action (the generic force)."""
    act_j, act_t = both_actions("iwasaki", nc)
    u = np.asarray(jfields.hot_start(LAT, nc, seed=68 + nc))
    ref = np.asarray(jgf.gradientflow(nc, nflow=5, eps=0.02, action=act_j).flow(u))
    got = tgf.gradientflow(nc, nflow=5, eps=0.02, action=act_t).flow(to_torch(u))
    assert np.abs(ref - to_numpy(got)).max() < TOL
    assert float(tsun.unitarity_defect(got)) < TOL
