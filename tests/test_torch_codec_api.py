"""The port's functional codec API and learning-rate schedules against the
JAX package's, on the CPU.

Same numpy inputs from a seed go through ``repro`` (eagerly) and
``repro_torch``:

* ``MoniquaCodec.encode / payload_value / decode / decode_self /
  payload_bytes / max_error``.  The reference rounds with
  ``jax.random.uniform`` on its key; the test hands those draws to the
  port's plain codec (``uniforms=``).  Its kernel codec (``use_pallas``,
  interpret mode here) hashes the key's last word (``kops._key_to_seed``),
  which the port's ``use_kernels`` codec takes as ``seed=``.  Payloads are
  bitwise, decodes bitwise against the reference's eager path (on the card
  the point-decode kernel holds ``tests/test_torch_decode.py``'s bound).
* ``quantize_codes`` / ``dequantize_codes`` / ``quantize``, ``mod_unit``,
  ``error_bound``, ``bits_for_delta``: bitwise / exact.
* ``moniqua_gossip`` with the reference's per-leaf draws (split keys):
  bitwise, ledger bytes equal; ``payload_bytes_tree`` / ``dtype_bytes_tree``.
* ``step_decay``, ``cosine``, ``theorem_lr`` at steps 0..N: the port
  computes in double, the reference in float32, so they agree within
  ``SCHED_ULPS`` float32 ulp of ``lr`` (``theorem_lr`` exactly); and a
  ``TrainStepConfig.lr_schedule`` drives the step size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import gossip as jgossip
from repro.core import modulo as jmod
from repro.core import quantizers as jq
from repro.core import topology as jtopo
from repro.core.moniqua import MoniquaCodec as JCodec
from repro.kernels import ops as jops
from repro.optim import sgd as jsgd
from repro_torch import tree
from repro_torch.comm import gossip as tgossip
from repro_torch.core import modulo as tmod
from repro_torch.core import quantizers as tq
from repro_torch.core import topology as ttopo
from repro_torch.core.moniqua import MoniquaCodec as TCodec
from repro_torch.kernels import ops as tops
from repro_torch.optim import sgd as tsgd

SCHED_ULPS = 4
SPECS = [(8, True), (4, True), (2, True), (1, False), (8, False),
         (4, False)]
SPEC_IDS = [f"{b}{'s' if s else 'n'}" for b, s in SPECS]


def _codecs(bits, stochastic, kernels=False):
    return (JCodec(jq.QuantSpec(bits=bits, stochastic=stochastic),
                   use_pallas=kernels),
            TCodec(tq.QuantSpec(bits=bits, stochastic=stochastic),
                   use_kernels=kernels))


def _pair(shape, theta, seed=0):
    """Sender x and receiver y within theta of each other, values far
    outside [-B/2, B/2) so the modulo wraps."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal(shape) * 10).astype(np.float32)
    x = (y + rng.uniform(-0.9, 0.9, shape) * theta).astype(np.float32)
    return x, y


def _draws(key, shape, stochastic):
    if not stochastic:
        return None
    return torch.from_numpy(np.array(jax.random.uniform(key, shape)))


@pytest.mark.parametrize("shape", [(37,), (3, 29), (2, 3, 16)])
@pytest.mark.parametrize("bits,stochastic", SPECS, ids=SPEC_IDS)
def test_plain_codec_matches_reference(bits, stochastic, shape):
    """encode with the reference's uniforms: payload bitwise; its
    payload_value, decode and decode_self bitwise the reference's eager
    ones; the decode within Lemma 2's bound of x."""
    theta = 0.7
    jc, tc = _codecs(bits, stochastic)
    x, y = _pair(shape, theta, bits)
    key = jax.random.PRNGKey(bits)
    pj = jc.encode(jnp.asarray(x), theta, key if stochastic else None)
    pt = tc.encode(torch.from_numpy(x), theta,
                   _draws(key, shape, stochastic))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(
        tc.payload_value(pt, theta, shape[-1]).numpy(),
        np.asarray(jc.payload_value(pj, theta, shape[-1])))
    dj = jc.decode(pj, jnp.asarray(y), theta)
    dt = tc.decode(pt, torch.from_numpy(y), theta)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(
        tc.decode_self(pt, torch.from_numpy(x), theta).numpy(),
        np.asarray(jc.decode_self(pj, jnp.asarray(x), theta)))
    bound = tc.max_error(theta)
    err = float((dt - torch.from_numpy(x)).abs().max())
    assert err <= bound * (1 + 1e-5)
    assert tc.payload_bytes(shape) == jc.payload_bytes(shape) == pt.numel()


@pytest.mark.parametrize("shape", [(37,), (3, 29)])
@pytest.mark.parametrize("bits,stochastic", [(8, True), (1, False),
                                             (4, True)],
                         ids=["8s", "1n", "4s"])
def test_kernel_codec_matches_reference(bits, stochastic, shape):
    """``use_kernels`` (the CUDA encode's plain version on the CPU) with
    the key's hash seed == the reference's ``use_pallas`` codec in interpret
    mode: payload bitwise; decode / decode_self (the point decode's plain
    version) bitwise the reference's."""
    theta = 0.7
    jc, tc = _codecs(bits, stochastic, kernels=True)
    x, y = _pair(shape, theta, 3 + bits)
    key = jax.random.PRNGKey(5 + bits)
    seed = int(jops._key_to_seed(key))
    pj = jc.encode(jnp.asarray(x), theta, key)
    pt = tc.encode(torch.from_numpy(x), theta, seed=seed)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(
        tc.decode(pt, torch.from_numpy(y), theta).numpy(),
        np.asarray(jc.decode(pj, jnp.asarray(y), theta)))
    np.testing.assert_array_equal(
        tc.decode_self(pt, torch.from_numpy(x), theta).numpy(),
        np.asarray(jc.decode_self(pj, jnp.asarray(x), theta)))
    np.testing.assert_array_equal(
        tc.payload_value(pt, theta, shape[-1]).numpy(),
        np.asarray(jc.payload_value(pj, theta, shape[-1])))


@pytest.mark.parametrize("bits", [8, 4, 1])
def test_ops_unpack_and_recover_match_reference(bits):
    """``ops.moniqua_unpack_value`` (the kernels' shared unpack, cut to the
    last dim) and ``ops.moniqua_recover`` bitwise the reference's."""
    theta = 0.7
    spec_j = jq.QuantSpec(bits=bits, stochastic=False)
    spec_t = tq.QuantSpec(bits=bits, stochastic=False)
    x, y = _pair((3, 29), theta, 11 + bits)
    B = float(jmod.b_theta(theta, spec_j.delta))
    pj = JCodec(spec_j).encode(jnp.asarray(x), theta)
    pt = torch.from_numpy(np.asarray(pj))
    qj = jops.moniqua_unpack_value(pj, B, spec_j, 29)
    qt = tops.moniqua_unpack_value(pt, B, spec_t, 29)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(
        tops.moniqua_recover(qt, torch.from_numpy(y), B).numpy(),
        np.asarray(jops.moniqua_recover(qj, jnp.asarray(y), B)))


def test_codec_draws_and_errors():
    """A generator draws the rounding (the same generator seed, the same
    payload); stochastic rounding without draws raises; a bfloat16
    receiver decodes in float32 on both codecs."""
    x, y = _pair((4, 33), 0.5, 9)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for kernels in (False, True):
        _, tc = _codecs(8, True, kernels)
        a = tc.encode(xt, 0.5, generator=torch.Generator().manual_seed(4))
        b = tc.encode(xt, 0.5, generator=torch.Generator().manual_seed(4))
        assert torch.equal(a, b)
        with pytest.raises(ValueError):
            tc.encode(xt, 0.5)
        d = tc.decode(a, yt.bfloat16(), 0.5)
        assert d.dtype == torch.float32
    _, plain = _codecs(8, True)
    _, kern = _codecs(8, True, kernels=True)
    p = plain.encode(xt, 0.5, torch.rand(x.shape))
    for y_ in (yt, yt.bfloat16()):
        assert torch.equal(plain.decode(p, y_, 0.5), kern.decode(p, y_, 0.5))
        assert torch.equal(plain.decode_self(p, y_, 0.5),
                           kern.decode_self(p, y_, 0.5))


@pytest.mark.parametrize("bits,stochastic", SPECS, ids=SPEC_IDS)
def test_quantize_helpers_match_reference(bits, stochastic):
    """quantize_codes (clamping values outside the box), dequantize_codes
    and quantize, with the reference's uniforms: bitwise."""
    rng = np.random.default_rng(bits)
    v = rng.uniform(-0.6, 0.6, (5, 41)).astype(np.float32)
    js = jq.QuantSpec(bits=bits, stochastic=stochastic)
    ts = tq.QuantSpec(bits=bits, stochastic=stochastic)
    key = jax.random.PRNGKey(bits)
    u = _draws(key, v.shape, stochastic)
    cj = jq.quantize_codes(jnp.asarray(v), js, key if stochastic else None)
    ct = tq.quantize_codes(torch.from_numpy(v), ts, u)
    assert ct.dtype == torch.uint8
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(tq.dequantize_codes(ct, ts).numpy(),
                                  np.asarray(jq.dequantize_codes(cj, js)))
    np.testing.assert_array_equal(
        tq.quantize(torch.from_numpy(v), ts, u).numpy(),
        np.asarray(jq.quantize(jnp.asarray(v), js,
                               key if stochastic else None)))
    if stochastic:
        with pytest.raises(ValueError):
            tq.quantize_codes(torch.from_numpy(v), ts)


def test_modulo_helpers_and_bits_bound_match_reference():
    z = (np.random.default_rng(0).standard_normal(1001) * 7).astype(
        np.float32)
    z[:4] = [0.5, -0.5, 1.5, -2.5]        # the half-open edge
    np.testing.assert_array_equal(tmod.mod_unit(torch.from_numpy(z)).numpy(),
                                  np.asarray(jmod.mod_unit(jnp.asarray(z))))
    for theta in (0.05, 0.5, 2.0):
        for delta in (1 / 512, 1 / 16, 0.25, 0.3):
            assert tmod.error_bound(theta, delta) == jmod.error_bound(
                theta, delta)
    for delta in (1 / 512, 1 / 256, 1 / 30, 0.1, 0.25, 0.49):
        assert tq.bits_for_delta(delta) == jq.bits_for_delta(delta)


def _gossip_tree(seed=0, theta=0.5):
    """Stacked leaves within theta of a common model, far from 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in (("w", (7, 13)), ("b", (11,)), ("c", (3, 2, 5))):
        base = rng.standard_normal(shape) * 5
        out[name] = (base + rng.uniform(-0.45, 0.45, (8,) + shape)
                     * theta).astype(np.float32)
    return out


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("bits,stochastic", [(8, True), (1, False),
                                             (4, True)],
                         ids=["8s", "1n", "4s"])
def test_moniqua_gossip_matches_reference(bits, stochastic, kernels):
    """One round with the reference's per-leaf draws (uniforms of the split
    keys for the plain codec, their hash seeds for the kernel codec):
    bitwise; the ledger credits the same bytes; one worker is the
    identity."""
    theta = 0.5
    X = _gossip_tree(bits)
    jc, tc = _codecs(bits, stochastic, kernels)
    key = jax.random.PRNGKey(21)
    keys = jax.random.split(key, 3)
    jl, tl = jgossip.BytesLedger(), tgossip.BytesLedger()
    ref = jgossip.moniqua_gossip(jax.tree.map(jnp.asarray, X),
                                 jtopo.ring(8), jc, theta,
                                 key if stochastic or kernels else None,
                                 ledger=jl)
    Xt = {k: torch.from_numpy(v) for k, v in X.items()}
    kw = {}
    if kernels:
        kw["seeds"] = [int(jops._key_to_seed(k)) for k in keys]
    elif stochastic:
        leaves, td = jax.tree.flatten(X)
        kw["uniforms"] = jax.tree.unflatten(td, [
            torch.from_numpy(np.array(jax.random.uniform(k, l.shape)))
            for k, l in zip(keys, leaves)])
    out = tgossip.moniqua_gossip(Xt, ttopo.ring(8), tc, theta, ledger=tl,
                                 **kw)
    for k in X:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    assert (tl.bytes_per_worker, tl.bytes_slow) == (jl.bytes_per_worker,
                                                   jl.bytes_slow) != (0, 0)
    one = {"w": Xt["w"][:1]}
    assert tgossip.moniqua_gossip(one, ttopo.ring(1), tc, theta) is one


def test_tree_byte_counts_match_reference():
    X = {"w": np.zeros((8, 7, 13), np.float32),
         "b": np.zeros((8, 11), np.float32),
         "h": np.zeros((8, 3, 5), jnp.bfloat16), "s": np.zeros((8,),
                                                               np.float32)}
    Xj = jax.tree.map(jnp.asarray, X)
    Xt = {"w": torch.zeros(8, 7, 13), "b": torch.zeros(8, 11),
          "h": torch.zeros(8, 3, 5, dtype=torch.bfloat16),
          "s": torch.zeros(8)}
    assert tgossip.dtype_bytes_tree(Xt) == jgossip.dtype_bytes_tree(Xj)
    for bits in (1, 2, 4, 8):
        jc, tc = _codecs(bits, bits > 1)
        assert (tgossip.payload_bytes_tree(Xt, tc)
                == jgossip.payload_bytes_tree(Xj, jc))


def _close_to_ref(port, ref, lr):
    tol = SCHED_ULPS * np.finfo(np.float32).eps * lr
    assert abs(port - float(ref)) <= tol, (port, float(ref))


@pytest.mark.parametrize("boundaries,factor", [((250, 280), 0.1),
                                               ((3, 7, 9), 0.5), ((), 0.1)])
def test_step_decay_matches_reference(boundaries, factor):
    """The paper's Sec. 6 schedule (decay by 0.1 at epochs 250 and 280)
    and others, at steps 0..300."""
    t, j = (tsgd.step_decay(0.1, boundaries, factor),
            jsgd.step_decay(0.1, boundaries, factor))
    for k in range(0, 301):
        _close_to_ref(t(k), j(k), 0.1)
    if boundaries:
        assert t(boundaries[0] - 1) == 0.1
        assert t(boundaries[-1]) == pytest.approx(
            0.1 * factor ** len(boundaries))


@pytest.mark.parametrize("floor", [0.0, 0.01])
def test_cosine_matches_reference(floor):
    t, j = tsgd.cosine(0.4, 50, floor), jsgd.cosine(0.4, 50, floor)
    for k in range(0, 61):
        _close_to_ref(t(k), j(k), 0.4)
    assert t(0) == pytest.approx(0.4) and t(60) == pytest.approx(floor)


def test_theorem_lr_matches_reference():
    for K, n in ((1000, 8), (64, 2), (10 ** 6, 64)):
        for sigma, zeta, L in ((1.0, 1.0, 2.0), (0.5, 2.0, 1.0)):
            assert tsgd.theorem_lr(K, n, sigma, zeta, L) == jsgd.theorem_lr(
                K, n, sigma, zeta, L)


def test_train_step_follows_lr_schedule():
    """``TrainStepConfig.lr_schedule`` sets each step's size: step 0 of a
    step-decay schedule is bitwise a constant-lr step at its value, and
    the reported ``alpha`` follows the decay."""
    import dataclasses
    from repro_torch.core.algorithms import AlgoHyper, get_algorithm
    from repro_torch.data.synthetic import stacked_cifar_like
    from repro_torch.models.resnet import ResNetModel
    from repro_torch.train import train_step as TS
    model = ResNetModel(depth=8, width=8, device="cpu")
    hp = AlgoHyper(topo=ttopo.ring(2))
    base = TS.TrainStepConfig(algo="dpsgd", lr=0.05)
    sched = dataclasses.replace(base, lr_schedule=tsgd.step_decay(
        0.05, (1,), 0.1))
    batches = [stacked_cifar_like(k, 4, 2, seed=0, device="cpu")
               for k in range(2)]
    algo = get_algorithm("dpsgd")
    outs = {}
    for name, cfg in (("const", base), ("sched", sched)):
        state = TS.init_state(model, algo, hp, 2, seed=0)
        step = TS.make_train_step(model, hp, cfg)
        alphas = []
        for k in range(2):
            state, m = step(state, batches[k], seed=k)
            alphas.append(m["alpha"])
            if k == 0:
                outs[name] = [t.clone() for t in tree.leaves(state["params"])]
        outs[name + "_alpha"] = alphas
    assert all(torch.equal(a, b) for a, b in zip(outs["const"],
                                                 outs["sched"]))
    assert outs["sched_alpha"] == [0.05, 0.05 * 0.1]
    assert outs["const_alpha"] == [0.05, 0.05]
