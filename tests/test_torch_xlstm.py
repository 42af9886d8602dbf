"""The ssm family (sLSTM + mLSTM blocks: xlstm-125m) in the port against the
JAX package.

The mLSTM and sLSTM pieces at small shapes, then xlstm-125m at the
reference's reduced size (2 layers: an sLSTM block, then an mLSTM block; d
256, 4 heads of 64, chunk 32, vocab 512).  Weights from the reference's
init, carried across with ``repro_torch.convert``; inputs are numpy draws
handed to both.

Tolerances (``tests/test_torch_llama.py``'s and
``tests/test_torch_zamba.py``'s):

* ``_mlstm_scan_chunks`` in float32 within 1e-5 x max of the reference and
  of the reference evaluated in float64; in bfloat16 within 3e-2 x max;
* ``mlstm_block``, ``mlstm_decode``, ``_slstm_step``, ``slstm_block`` and
  ``slstm_decode`` within 1e-5 x max (float32);
* the model: logits within 1e-4 x max|logit| in float32 and 3e-2 in
  bfloat16; per-worker losses ``rtol=1e-5`` and gradients 1e-4 of each
  leaf's largest entry; one Moniqua train step with
  ``tests/test_torch_lm_train.py``'s;
* the mLSTM gradient at the published chunk of 128 within 1e-4 x max of
  the reference evaluated in float64.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import InputShape as JShape
from repro.models import xlstm as JXL
from repro_torch import convert, tree
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import InputShape as TShape
from repro_torch.models import xlstm as TXL
from repro_torch.models.model_factory import build_model as tbuild
from torch_family_cases import one_thread  # noqa: F401 (autouse fixture)
from torch_family_cases import (check_batch_spec, check_loss_and_grads,
                                check_moniqua_step, check_trainer_bytes,
                                models, rel, tokens)

ARCH = "xlstm-125m"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
B, S = 2, 64


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jget_config(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(tget_config(ARCH).reduced(), dtype=dtype))


def _models(dtype="float32"):
    return models(*_cfgs(dtype))


# -- the mLSTM cell ----------------------------------------------------------

def _scan_inputs(S=96, H=4, D=16, seed=0):
    """q, k, v and the log gates ``log_sigmoid(N(0, 1))`` (<= 0)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, S, H, D)).astype(np.float32)
               for _ in range(3))
    lf, li = (-np.log1p(np.exp(-rng.standard_normal((2, S, H))))
              .astype(np.float32) for _ in range(2))
    return q, k, v, lf, li


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_scan_chunks_matches_reference(dtype):
    """Three chunks of 32: q, k, v in ``dtype``, the log gates float32."""
    q, k, v, lf, li = _scan_inputs()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ht = TXL._mlstm_scan_chunks(*(torch.from_numpy(a).to(tdt)
                                  for a in (q, k, v)),
                                torch.from_numpy(lf), torch.from_numpy(li), 32)
    assert ht.dtype == tdt and tuple(ht.shape) == q.shape
    scan = jax.jit(JXL._mlstm_scan_chunks, static_argnums=5)
    hj = scan(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
              jnp.asarray(lf), jnp.asarray(li), 32)
    if dtype == "bfloat16":
        assert rel(ht, hj) <= 3e-2
        return
    assert rel(ht, hj) <= 1e-5
    with jax.enable_x64(True):
        h64 = np.asarray(scan(
            *(jnp.asarray(a, jnp.float64) for a in (q, k, v, lf, li)), 32))
    assert np.abs(ht.double().numpy() - h64).max() <= 1e-5 * np.abs(h64).max()


def test_mlstm_scan_rejects_a_ragged_sequence():
    q, k, v, lf, li = (torch.from_numpy(a) for a in _scan_inputs(S=40))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TXL._mlstm_scan_chunks(q, k, v, lf, li, 32)


def test_mlstm_gradient_stays_finite_at_the_published_chunk():
    """One chunk of 128 (xlstm-125m's): above the diagonal the intra-chunk
    exponent ``F_t - F_s + li_s`` grows ~0.8 a step and passes float32's
    ``exp`` range.  The reference's masked ``exp`` then gives gradients
    ``0 * inf = nan``; the port's (``exp`` of ``-inf`` there) stay finite
    and within 1e-4 x max of the reference's evaluated in float64."""
    q, k, v, lf, li = _scan_inputs(S=128, H=2, D=8, seed=1)
    wgt = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)

    def jf(q, k, v, lf, li):
        return jnp.sum(JXL._mlstm_scan_chunks(q, k, v, lf, li, 128) * wgt)

    def tf(q, k, v, lf, li):
        return (TXL._mlstm_scan_chunks(q, k, v, lf, li, 128)
                * torch.from_numpy(wgt)).sum()
    args = (q, k, v, lf, li)
    jgrad = jax.jit(jax.grad(jf, argnums=(0, 1, 2, 3, 4)))
    j32 = jgrad(*map(jnp.asarray, args))
    assert not all(np.isfinite(np.asarray(g)).all() for g in j32)
    got = torch.func.grad(tf, argnums=(0, 1, 2, 3, 4))(
        *map(torch.from_numpy, args))
    with jax.enable_x64(True):
        want = jgrad(*(jnp.asarray(a, jnp.float64) for a in args))
        want = [np.asarray(w) for w in want]
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert np.abs(w).max() > 0
        assert np.abs(g.double().numpy() - w).max() <= 1e-4 * np.abs(w).max()


def _block_case(kind):
    jcfg, tcfg = _cfgs()
    init = JXL.init_slstm if kind == "slstm" else JXL.init_mlstm
    p = init(jax.random.PRNGKey(3), jcfg)
    tp = convert.to_torch(jax.tree.map(np.asarray, p), device="cpu")
    x = np.random.default_rng(4).standard_normal((B, S, jcfg.d_model)
                                                 ).astype(np.float32)
    return jcfg, tcfg, p, tp, x


def test_mlstm_block_and_decode_match_reference():
    """The block on 64 tokens (2 chunks); then 8 tokens one at a time from
    a zero state: each output and the state after it; the chain equals the
    block's forward on the same 8 tokens."""
    jcfg, tcfg, p, tp, x = _block_case("mlstm")
    yj = jax.jit(lambda p, x: JXL.mlstm_block(p, jcfg, x))(p, x)
    yt = TXL.mlstm_block(tp, tcfg, torch.from_numpy(x))
    assert rel(yt - torch.from_numpy(x), np.asarray(yj) - x) <= 1e-5
    jdecode = jax.jit(lambda p, x, s: JXL.mlstm_decode(p, jcfg, x, s))
    js = JXL.init_mlstm_state(B, jcfg)
    ts = TXL.init_mlstm_state(B, tcfg, "cpu")
    outs = []
    for s in range(8):
        xs = x[:, s:s + 1]
        jo, js = jdecode(p, xs, js)
        to, ts = TXL.mlstm_decode(tp, tcfg, torch.from_numpy(xs), ts)
        assert rel(to - torch.from_numpy(xs), np.asarray(jo) - xs) <= 1e-5
        assert rel(ts["C"], js["C"]) <= 1e-5
        assert rel(ts["n"], js["n"]) <= 1e-5
        outs.append(to)
    cfg8 = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm,
                                                             chunk=8))
    full = TXL.mlstm_block(tp, cfg8, torch.from_numpy(x[:, :8]))
    assert rel(torch.cat(outs, 1), full.numpy()) <= 1e-5


def test_slstm_step_block_and_decode_match_reference():
    """One ``_slstm_step`` from a seeded state; the block on 64 tokens;
    ``slstm_decode`` over the first 8 tokens, which equals the block's
    first 8 positions."""
    jcfg, tcfg, p, tp, x = _block_case("slstm")
    rng = np.random.default_rng(5)
    d, nh = jcfg.d_model, jcfg.num_heads
    wx = rng.standard_normal((B, 4 * d)).astype(np.float32)
    st = {k: rng.standard_normal((B, nh, d // nh)).astype(np.float32)
          for k in ("h", "c", "n")}
    js = JXL._slstm_step(p, jcfg, jnp.asarray(wx),
                         jax.tree.map(jnp.asarray, st))
    ts = TXL._slstm_step(tp, tcfg, torch.from_numpy(wx),
                         {k: torch.from_numpy(v) for k, v in st.items()})
    for k in ("h", "c", "n"):
        assert rel(ts[k], js[k]) <= 1e-5
    yj = jax.jit(lambda p, x: JXL.slstm_block(p, jcfg, x))(p, x)
    yt = TXL.slstm_block(tp, tcfg, torch.from_numpy(x))
    assert rel(yt - torch.from_numpy(x), np.asarray(yj) - x) <= 1e-5
    jdecode = jax.jit(lambda p, x, s: JXL.slstm_decode(p, jcfg, x, s))
    js = JXL.init_slstm_state(B, jcfg)
    ts = TXL.init_slstm_state(B, tcfg, "cpu")
    for s in range(8):
        xs = x[:, s:s + 1]
        jo, js = jdecode(p, xs, js)
        to, ts = TXL.slstm_decode(tp, tcfg, torch.from_numpy(xs), ts)
        assert rel(to - torch.from_numpy(xs), np.asarray(jo) - xs) <= 1e-5
        assert rel(to, yt[:, s:s + 1].numpy()) <= 1e-6
        for k in ("h", "c", "n"):
            assert rel(ts[k], js[k]) <= 1e-5


def _slstm_loop_block(p, cfg, x):
    """``slstm_block`` as the reference writes it: ``_slstm_step`` a
    position, differentiated by autograd."""
    B, S, d = x.shape
    wx = TXL.L.rms_norm(x, p["ln"]) @ p["w"]
    st = TXL.init_slstm_state(B, cfg, x.device)
    hs = []
    for t in range(S):
        st = TXL._slstm_step(p, cfg, wx[:, t], st)
        hs.append(st["h"])
    return x + torch.stack(hs, dim=1).reshape(B, S, d) @ p["w_down"]


def test_slstm_scan_backward_matches_autograd_of_the_step_loop(monkeypatch):
    """``_SLSTMScan``'s hand-written backward under ``vmap(grad)`` (two
    workers, 40 positions) against autograd through the loop of
    ``_slstm_step``: every parameter's and the input's gradient within
    1e-5 x max (float32); the backward runs once for both workers (its
    ``vmap`` rule folds them)."""
    _, tcfg = _cfgs()
    p = convert.to_torch(jax.tree.map(np.asarray, JXL.init_slstm(
        jax.random.PRNGKey(6), _cfgs()[0])), device="cpu")
    gen = torch.Generator().manual_seed(0)
    X = {k: v[None] + 0.02 * torch.randn((2,) + v.shape, generator=gen)
         for k, v in p.items()}
    x = torch.randn((2, B, 40, tcfg.d_model), generator=gen)
    w = torch.randn((2, B, 40, tcfg.d_model), generator=gen)
    calls = []
    bwd = TXL._slstm_scan_bwd
    monkeypatch.setattr(TXL, "_slstm_scan_bwd",
                        lambda *a: calls.append(a[0].shape) or bwd(*a))

    def loss(block):
        return lambda p, x, w: (block(p, tcfg, x) * w).sum()
    got = torch.func.vmap(torch.func.grad(loss(TXL.slstm_block),
                                          argnums=(0, 1)))(X, x, w)
    assert len(calls) == 1 and calls[0][0] == 2
    want = torch.func.vmap(torch.func.grad(loss(_slstm_loop_block),
                                           argnums=(0, 1)))(X, x, w)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


# -- xlstm-125m, reduced -------------------------------------------------------

def test_reduced_config_has_both_blocks():
    _, tcfg = _cfgs()
    tm = tbuild(tcfg, device="cpu")
    assert tcfg.family == "ssm" and tcfg.ssm.chunk == 32
    assert [tm._is_slstm(i) for i in range(tcfg.num_layers)] == [True, False]
    p = tm.init(tm.generator(0))
    assert [set(bp) for bp in p["layers"]] == [{"slstm"}, {"mlstm"}]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """Prefill logits (all positions and ``last_only``), then 8 decode
    steps from an empty cache: logits, ``pos`` and every layer's state."""
    jm, tm, params, tp = _models(dtype)
    toks = tokens(jm.cfg.vocab_size, (B, S))
    ref = np.asarray(jax.jit(jm.prefill_logits)(
        params, {"tokens": jnp.asarray(toks)}))
    for last_only in (False, True):
        got = tm.prefill_logits(tp, {"tokens": torch.from_numpy(toks)},
                                last_only=last_only)
        assert got.dtype == torch.float32
        assert rel(got, ref[:, -1:] if last_only else ref) <= TOL[dtype]
    dec = tokens(jm.cfg.vocab_size, (B, 8), seed=1)
    jc = jm.init_cache(B, JShape("d", 16, B, "decode"))
    tc = tm.init_cache(B, TShape("d", 16, B, "decode"))
    assert jax.tree.structure(jax.tree.map(np.asarray, jc)) == \
        jax.tree.structure(convert.to_numpy(tc))
    jdecode = jax.jit(jm.decode_step)
    for s in range(8):
        jl, jc = jdecode(params, jc, jnp.asarray(dec[:, s:s + 1]))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(dec[:, s:s + 1]))
        assert rel(tl, jl) <= TOL[dtype]
        assert int(jc["pos"]) == int(tc["pos"]) == s + 1
    for a, c in zip(jax.tree.leaves(jc["layers"]), tree.leaves(tc["layers"])):
        assert tuple(c.shape) == a.shape and str(c.dtype) == f"torch.{dtype}"
        assert rel(c, a) <= TOL[dtype]


def test_decode_matches_prefill():
    """Float32: the prompt fed token by token through ``decode_step`` gives
    prefill's logits at every position, within 1e-4 x max|logit|."""
    _, tm, _, tp = _models()
    toks = torch.from_numpy(tokens(tm.cfg.vocab_size, (B, S), seed=3))
    want = tm.prefill_logits(tp, {"tokens": toks})
    cache = tm.init_cache(B, TShape("d", S, B, "decode"))
    got = []
    for s in range(S):
        lg, cache = tm.decode_step(tp, cache, toks[:, s:s + 1])
        got.append(lg)
    assert rel(torch.cat(got, 1), want.numpy()) <= 1e-4


def _lm_batch(vocab, n, seed):
    toks = tokens(vocab, (n, B, S + 1), seed=seed)
    return {"tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy()}


def test_batch_spec_matches_reference():
    jm, tm, _, _ = _models()
    check_batch_spec(jm, tm, 2048, 8)


def test_per_worker_loss_and_grads_match_reference():
    """Two workers' losses and gradients (the train step's ``vmap(grad)``,
    through ``_SLSTMScan``'s backward) against the reference's."""
    jm, tm, params, _ = _models()
    check_loss_and_grads(jm, tm, params, _lm_batch(jm.cfg.vocab_size, 2, 2))


def test_moniqua_train_step_matches_reference():
    """One Moniqua 8-bit ``train_step`` on ring(2) over the xlstm tree (a
    list of layer dicts)."""
    jm, tm, params, _ = _models()
    check_moniqua_step(jm, tm, params, _lm_batch(jm.cfg.vocab_size, 2, 5))


def test_trainer_on_xlstm_matches_reference_bytes():
    """``Trainer(model, tc, shape)`` on the reduced config in bf16, as
    published: bytes per step equal the reference ``Trainer``'s."""
    check_trainer_bytes(*_cfgs("bfloat16"), ("tiny", 32, 4, "train"))
