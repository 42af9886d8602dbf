"""The port's AD-PSGD (Algorithm 3) against the JAX package's, on the CPU.

``CommEngine.pair_average`` on the ``full`` and ``moniqua`` wires is held
bitwise against the reference's eager one (its jnp ops, op by op).  The
simulator ``run`` is held against ``repro.core.adpsgd.run`` under the
reference's own schedule: the test replays the reference's key splitting
(worker, staleness, neighbour, gradient noise and exchange key of every
iteration) and hands the draws to the port.  Run eagerly
(``jax.disable_jit``) the reference does the same float32 operations and the
final models are bitwise; run as the reference runs it, jitted under
``lax.scan``, XLA contracts multiply-adds in the decode (ROADMAP Queue 3),
so there the models are held within ``ULPS_PER_EXCHANGE`` ulp of
max(|x|, B) for every exchange of the run.  The mean-model trace is a sum
over workers, which the two packages take in other orders: it is held
within a few ulp of its largest value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import engine as jeng
from repro.core import adpsgd as jad
from repro.core import modulo as jmod
from repro.core import topology as jtopo
from repro.core.moniqua import MoniquaCodec as JCodec
from repro.core.quantizers import QuantSpec as JSpec
from repro.data.synthetic import quadratic_grad as j_quadratic_grad
from repro.kernels import ops as jops
from repro_torch.comm import engine as teng
from repro_torch.core import adpsgd as tad
from repro_torch.core import topology as ttopo
from repro_torch.core.moniqua import MoniquaCodec as TCodec
from repro_torch.core.quantizers import QuantSpec as TSpec
from repro_torch.data.synthetic import quadratic_grad as t_quadratic_grad

N, D = 6, 16
DELTA, SIGMA = 0.2, 0.05
ULPS_PER_EXCHANGE = 2
EPS = float(np.finfo(np.float32).eps)


def _engines(wire, bits):
    if wire == "full":
        return (jeng.CommEngine(jtopo.ring(N), jeng.FullPrecisionWire(),
                                backend="jnp"),
                teng.CommEngine(ttopo.ring(N), teng.FullPrecisionWire()))
    spec = dict(bits=bits, stochastic=bits > 1)
    return (jeng.CommEngine(jtopo.ring(N), jeng.MoniquaWire(JSpec(**spec)),
                            backend="jnp"),
            teng.CommEngine(ttopo.ring(N), teng.MoniquaWire(TSpec(**spec))))


@pytest.mark.parametrize("wire,bits", [("full", 8), ("moniqua", 1),
                                       ("moniqua", 2), ("moniqua", 4),
                                       ("moniqua", 8)])
@pytest.mark.parametrize("shape", [(16,), (37,), (3, 29)])
@pytest.mark.parametrize("theta", [0.5, 2.0])
def test_pair_average_bitwise(wire, bits, shape, theta):
    """Both endpoints of one exchange equal the reference's eager
    ``pair_average``, on ragged and 2-d models whose gap wraps mod B."""
    rng = np.random.default_rng(bits + len(shape))
    xi = (rng.standard_normal(shape) * 3).astype(np.float32)
    xj = (xi + rng.uniform(-theta, theta, shape)).astype(np.float32)
    je, te = _engines(wire, bits)
    key = jax.random.PRNGKey(11)
    ref = je.pair_average(jnp.asarray(xi), jnp.asarray(xj), theta=theta,
                          key=key)
    out = te.pair_average(torch.from_numpy(xi), torch.from_numpy(xj),
                          theta=theta, seed=int(jops._key_to_seed(key)))
    for a, b in zip((ref.xi, ref.xj), (out.xi, out.xj)):
        assert b.dtype == torch.float32 and tuple(b.shape) == shape
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("wire,bits", [("full", 8), ("moniqua", 1),
                                       ("moniqua", 8)])
def test_pair_average_bfloat16_bitwise(wire, bits):
    """A bfloat16 pair: the reference promotes the decoded float32 values
    and returns float32 endpoints (the full wire stays bfloat16); so does
    the port, bit for bit."""
    rng = np.random.default_rng(70 + bits)
    xi32 = (rng.standard_normal(37) * 3).astype(np.float32)
    xj32 = (xi32 + rng.uniform(-1, 1, 37)).astype(np.float32)
    ti, tj = (torch.from_numpy(a).bfloat16() for a in (xi32, xj32))
    ji, jj = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              for t in (ti, tj))
    je, te = _engines(wire, bits)
    key = jax.random.PRNGKey(12)
    ref = je.pair_average(ji, jj, theta=1.0, key=key)
    out = te.pair_average(ti, tj, theta=1.0, seed=int(jops._key_to_seed(key)))
    for a, b in zip((ref.xi, ref.xj), (out.xi, out.xj)):
        assert str(b.dtype)[6:] == str(a.dtype)
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      b.float().numpy())


def test_pair_average_rejects_what_is_not_ported():
    _, te = _engines("moniqua", 8)
    x = torch.zeros(8)
    # presence is ported: a missing endpoint makes the identity exchange
    y = torch.ones(8)
    res = te.pair_average(x, y, theta=1.0, seed=0, presence=(1, 0))
    assert res.xi is x and res.xj is y
    with pytest.raises(ValueError, match="length"):
        te.pair_average(x, x, theta=1.0, seed=0, presence=(1, 0, 1))
    assert teng.make_wire("qsgd", TSpec(8)).name == "qsgd"
    with pytest.raises(ValueError, match="unknown wire"):
        teng.make_wire("topk", TSpec(8))
    with pytest.raises(ValueError):           # stochastic wire, no seed
        te.pair_average(x, x, theta=1.0)


def _ref_schedule(key, cfg, iters):
    """The reference ``run``'s draws, replayed from its key splitting."""
    n_off = len(cfg.topo.neighbor_offsets())
    out = {k: [] for k in ("i", "tau", "nb", "seed", "noise")}
    kkey = key
    for _ in range(iters):
        kkey, k_i, k_tau, k_nb, k_g, k_q = jax.random.split(kkey, 6)
        out["i"].append(int(jax.random.randint(k_i, (), 0, N)))
        out["tau"].append(int(jax.random.randint(k_tau, (), 0,
                                                 cfg.max_delay + 1)))
        out["nb"].append(int(jax.random.randint(k_nb, (), 0, n_off)))
        out["seed"].append(int(jops._key_to_seed(k_q)))
        out["noise"].append(np.asarray(jax.random.normal(k_g, (D,))))
    sched = {k: torch.tensor(v) for k, v in out.items() if k != "noise"}
    sched["noise"] = torch.from_numpy(np.stack(out["noise"]))
    return sched


def _configs(quantized, bits=8, theta=0.5):
    spec = dict(bits=bits, stochastic=bits > 1)
    kw = dict(theta=theta, max_delay=4, quantized=quantized)
    return (jad.ADPSGDConfig(topo=jtopo.ring(N), codec=JCodec(JSpec(**spec)),
                             **kw),
            tad.ADPSGDConfig(topo=ttopo.ring(N), codec=TCodec(TSpec(**spec)),
                             **kw))


def _runs(quantized, iters, bits=8, jit=True, alpha=0.05):
    jcfg, tcfg = _configs(quantized, bits)
    x0 = np.random.default_rng(5).standard_normal((N, D)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    def jgrad(x, i, k):
        return j_quadratic_grad(x, DELTA, k, SIGMA)

    if jit:
        Xj, trace_j = jad.run(jnp.asarray(x0), jgrad, alpha, iters, jcfg, key)
    else:
        with jax.disable_jit():
            Xj, trace_j = jad.run(jnp.asarray(x0), jgrad, alpha, iters, jcfg,
                                  key)
    Xt, trace_t = tad.run(
        torch.from_numpy(x0),
        lambda x, i, noise: t_quadratic_grad(x, DELTA, noise, SIGMA),
        alpha, iters, tcfg, schedule=_ref_schedule(key, jcfg, iters))
    return (np.asarray(Xj), np.asarray(trace_j)), (Xt.numpy(),
                                                   trace_t.numpy()), tcfg


def _trace_close(ref, out):
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=4 * EPS * np.abs(ref).max())


@pytest.mark.parametrize("quantized,bits", [(False, 8), (True, 8),
                                            (True, 2)])
def test_run_bitwise_against_the_eager_reference(quantized, bits):
    (Xj, tj), (Xt, tt), _ = _runs(quantized, 12, bits=bits, jit=False)
    np.testing.assert_array_equal(Xj, Xt)
    _trace_close(tj, tt)


@pytest.mark.parametrize("quantized", [False, True])
def test_run_matches_the_jitted_reference(quantized):
    """60 iterations (60 exchanges) against the reference as it runs,
    under jit and lax.scan: within ULPS_PER_EXCHANGE ulp of max(|x|, B)
    per exchange."""
    iters = 60
    (Xj, tj), (Xt, tt), tcfg = _runs(quantized, iters)
    B = float(jmod.b_theta(tcfg.theta, tcfg.codec.spec.delta))
    scale = max(np.abs(Xj).max(), B)
    tol = iters * ULPS_PER_EXCHANGE * EPS * scale
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=tol)
    np.testing.assert_allclose(tt, tj, rtol=0, atol=tol)


def test_moniqua_adpsgd_tracks_full_precision():
    """Under the port's own schedule (make_schedule), Moniqua on AD-PSGD
    reaches the quadratic's optimum as well as plain AD-PSGD, with workers
    near consensus (the reference's ``test_adpsgd.py`` claim)."""
    opt, iters = DELTA / 2.0, 1500
    gen = torch.Generator().manual_seed(0)
    noise = torch.randn((iters, D), generator=gen)
    errs = {}
    for quantized in (False, True):
        _, tcfg = _configs(quantized)
        sched = tad.make_schedule(N, iters, tcfg, seed=0)
        sched["noise"] = noise
        Xf, trace = tad.run(torch.zeros((N, D)), lambda x, i, z:
                            t_quadratic_grad(x, DELTA, z, SIGMA), 0.05,
                            iters, tcfg, schedule=sched)
        assert torch.isfinite(Xf).all()
        errs[quantized] = float(((trace[-1] - opt) ** 2).mean())
        spread = float((Xf - Xf.mean(0, keepdim=True)).abs().max())
        assert spread < 0.25
    assert errs[False] < 1e-2
    assert errs[True] < max(3.0 * errs[False], 1e-2)


def test_make_schedule_is_deterministic_and_in_range():
    _, tcfg = _configs(True)
    a, b = (tad.make_schedule(N, 200, tcfg, seed=4) for _ in range(2))
    for k in ("i", "tau", "nb", "seed"):
        assert torch.equal(a[k], b[k])
    assert 0 <= int(a["i"].min()) and int(a["i"].max()) < N
    assert int(a["tau"].max()) <= tcfg.max_delay
    assert int(a["nb"].max()) < len(tcfg.topo.neighbor_offsets())
    assert 0 <= int(a["seed"].min()) and int(a["seed"].max()) < 2 ** 32
