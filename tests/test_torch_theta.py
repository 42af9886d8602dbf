"""The port's theory (``repro_torch.core.theta``) against the JAX package's.

Every formula of Theorems 2-5 and the Sec. 4 bits bound, on the same
inputs, to 1e-12 relative (both are float64 numpy; only the order of a few
operations could differ), and D^2's lambda_n > -1/3 guard raising exactly
where the reference's raises.
"""
import numpy as np
import pytest

from repro.core import theta as jth
from repro.core import topology as jtopo
from repro_torch.core import theta as tth
from repro_torch.core import topology as ttopo

REL = 1e-12
# (family, n, slack): lambda_n of ring(8) is exactly -1/3, so plain rings
# and tori trip D^2's guard and their slack versions pass it
TOPOS = [("ring", 8, 1.0), ("ring", 8, 0.75), ("ring", 5, 1.0),
         ("ring", 16, 0.5), ("exponential", 8, 1.0), ("exponential", 16, 0.9),
         ("torus", 9, 1.0), ("torus", 16, 0.6), ("complete", 8, 1.0)]


def _topos(family, n, slack):
    jt, tt = jtopo.get_topology(family, n), ttopo.get_topology(family, n)
    if slack < 1.0:
        jt, tt = jt.slack(slack), tt.slack(slack)
    return jt, tt


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0)


@pytest.mark.parametrize("n", [2, 8, 64, 1024])
@pytest.mark.parametrize("rho", [0.0, 0.5, 0.9, 0.999])
def test_dpsgd_and_slack_formulas(n, rho):
    for alpha, g_inf in ((0.1, 1.0), (0.003, 7.5)):
        _close(tth.theta_dpsgd(alpha, g_inf, n, rho, 1.3, 0.8),
               jth.theta_dpsgd(alpha, g_inf, n, rho, 1.3, 0.8))
        for gamma in (1.0, 0.02):
            _close(tth.theta_slack(alpha, g_inf, n, rho, gamma),
                   jth.theta_slack(alpha, g_inf, n, rho, gamma))
    _close(tth.delta_dpsgd(n, rho), jth.delta_dpsgd(n, rho))
    _close(tth.delta_dpsgd(n, rho, 2.0, 0.5), jth.delta_dpsgd(n, rho, 2.0, 0.5))
    assert tth.bits_bound(n, rho) == jth.bits_bound(n, rho)
    for delta in (1 / 16, 0.25, 0.4):
        for K in (1, 100, 10 ** 6):
            _close(tth.gamma_slack(delta, n, K, rho),
                   jth.gamma_slack(delta, n, K, rho))


@pytest.mark.parametrize("family,n,slack", TOPOS)
def test_d2_formulas_and_guard(family, n, slack):
    jt, tt = _topos(family, n, slack)
    try:
        ref = jth._d2_constants(jt)
    except ValueError:
        with pytest.raises(ValueError, match="lambda_n > -1/3"):
            tth._d2_constants(tt)
        with pytest.raises(ValueError):
            tth.theta_d2(0.1, 1.0, tt)
        with pytest.raises(ValueError):
            tth.delta_d2(tt)
        return
    for a, b in zip(tth._d2_constants(tt), ref):
        _close(a, b)
    _close(tth.theta_d2(0.05, 2.0, tt), jth.theta_d2(0.05, 2.0, jt))
    _close(tth.delta_d2(tt), jth.delta_d2(jt))


def test_guard_trips_on_plain_ring_not_on_its_slack():
    with pytest.raises(ValueError):
        tth._d2_constants(ttopo.ring(8))
    d1, d2 = tth._d2_constants(ttopo.ring(8).slack(0.75))
    assert np.isfinite(d1) and np.isfinite(d2)


@pytest.mark.parametrize("t_mix", [1.0, 60.0, 1e4])
def test_adpsgd_formulas(t_mix):
    _close(tth.theta_adpsgd(0.05, 1.5, t_mix), jth.theta_adpsgd(0.05, 1.5, t_mix))
    _close(tth.delta_adpsgd(t_mix), jth.delta_adpsgd(t_mix))
    assert 0 < tth.delta_adpsgd(t_mix) < 0.5
