"""Port parity: the Wilson plaquette gauge action and gauge observables."""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from latticeqcd_tpu.measurements import observables as jobs  # noqa: E402
from latticeqcd_tpu.ops import fields as jfields  # noqa: E402
from latticeqcd_tpu.ops import gauge_action as jga  # noqa: E402
from latticeqcd_torch import convert  # noqa: E402
from latticeqcd_torch.convert import to_numpy  # noqa: E402
from latticeqcd_torch.measurements import observables as tobs  # noqa: E402
from latticeqcd_torch.ops import gauge_action as tga  # noqa: E402

to_torch = functools.partial(convert.to_torch, device="cpu")

TOL = 1e-12


@pytest.fixture(scope="module")
def links():
    return jfields.hot_start((4, 4, 2, 4), 3, seed=33)


def test_plaquette_action_and_observables(links):
    ut = to_torch(links)
    ja, ta = jga.wilson_gauge_action(3, 6.0), tga.wilson_gauge_action(3, 6.0)
    assert abs(float(jga.mean_plaquette(links)) - float(tga.mean_plaquette(ut))) < TOL
    s_j = float(jga.action_value(ja, links))
    assert abs(s_j - float(tga.action_value(ta, ut))) < TOL * abs(s_j)
    e_j = complex(jga.evaluate(ja, links))
    assert abs(e_j - complex(tga.evaluate(ta, ut))) < TOL * abs(e_j)
    assert abs(float(jobs.mean_plaquette(links)) - float(tobs.mean_plaquette(ut))) < TOL
    assert abs(complex(jobs.polyakov_loop(links)) - complex(tobs.polyakov_loop(ut))) < TOL


@pytest.mark.parametrize("oracle", ["force", "force_autodiff"])
def test_gauge_force(links, oracle):
    ja, ta = jga.wilson_gauge_action(3, 5.7), tga.wilson_gauge_action(3, 5.7)
    ref = np.asarray(getattr(jga, oracle)(ja, links))
    got = to_numpy(tga.force(ta, to_torch(links)))
    assert np.abs(ref - got).max() < TOL


def test_staples_match(links):
    ja, ta = jga.wilson_gauge_action(3, 6.0), tga.wilson_gauge_action(3, 6.0)
    for mu in range(4):
        ref = np.asarray(jga.staples(ja, links, mu))
        assert np.abs(ref - to_numpy(tga.staples(ta, to_torch(links), mu))).max() < TOL


def test_general_actions_raise():
    """Once refused, now ported: a general action gives the JAX package's
    staple, the rectangular set its loops; only an unknown set raises."""
    from latticeqcd_tpu.ops import wilsonline as jwl
    from latticeqcd_torch.ops import wilsonline

    u = jfields.hot_start((2, 2, 2, 2), 3, seed=34)
    act_j = jga.GaugeAction(3).push(1.0, jwl.make_loops_fromname("plaquette"))
    act_t = tga.GaugeAction(3).push(1.0, wilsonline.make_loops_fromname("plaquette"))
    for mu in range(4):
        ref = np.asarray(jga.staples(act_j, u, mu))
        assert np.abs(ref - to_numpy(tga.staples(act_t, to_torch(np.asarray(u)), mu))).max() < TOL
    assert ([l.segments for l in wilsonline.make_loops_fromname("rectangular")]
            == [l.segments for l in jwl.make_loops_fromname("rectangular")])
    with pytest.raises(ValueError, match="unknown loop set"):
        wilsonline.make_loops_fromname("hexagon")
