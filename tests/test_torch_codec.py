"""The port's codec against the JAX package, bit for bit, on the CPU.

Same numpy inputs from a seed go through the reference function (its jnp
path, as the reference engine runs it off-TPU, eagerly) and the port's
counterpart; every comparison is exact equality.  On the CPU the port's
kernel wrappers take their plain PyTorch versions, so this pins the
semantics the CUDA kernels are held to on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import modulo as jmod
from repro.core import quantizers as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import modulo as tmod
from repro_torch.core import quantizers as tq
from repro_torch.kernels import moniqua_decode_reduce as tdr
from repro_torch.kernels import moniqua_encode as tenc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

BITS = [1, 2, 4, 8]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _spec(bits, stochastic):
    return tq.QuantSpec(bits=bits, stochastic=stochastic), \
        jq.QuantSpec(bits=bits, stochastic=stochastic)


def _B(bits, stochastic):
    """B for the spec (1-bit stochastic has delta = 1/2: no B, use 0.7)."""
    if bits == 1 and stochastic:
        return np.float32(0.7), torch.tensor(0.7)
    delta = jq.delta_for_bits(bits, stochastic)
    return jmod.b_theta(2.0, delta), tmod.b_theta(2.0, delta, "cpu")


@pytest.mark.parametrize("a", [1.0, 0.37, 3.7])
def test_cmod_bitwise(a):
    rng = np.random.default_rng(0)
    z = (rng.standard_normal(4096) * 5 * a).astype(np.float32)
    edges = np.float32(a) * np.array([0.5, -0.5, 1.5, -1.5, 0, 2, -2],
                                     np.float32)
    z = np.concatenate([z, edges])
    out = tmod.cmod(torch.from_numpy(z), a)
    _eq(jmod.cmod(jnp.asarray(z), a), out)
    _eq(jref.cmod(jnp.asarray(z), a), tref.cmod(torch.from_numpy(z), a))
    # the half-open edge: a/2 maps to -a/2
    half = np.float32(a) / np.float32(2)
    assert tmod.cmod(torch.tensor([half]), a).item() == -half


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("stochastic", [True, False])
def test_b_theta_and_recover_bitwise(bits, stochastic):
    delta = jq.delta_for_bits(bits, stochastic)
    if delta >= 0.5:
        with pytest.raises(ValueError):
            tmod.b_theta(2.0, delta, "cpu")
        return
    for theta in (2.0, 0.3, 1e-3):
        _eq(jmod.b_theta(theta, delta), tmod.b_theta(theta, delta, "cpu"))
    rng = np.random.default_rng(bits)
    q, y = (rng.standard_normal((2, 999)) * 3).astype(np.float32)
    B = 2.0 / (1 - 2 * delta)
    _eq(jmod.recover(jnp.asarray(q), jnp.asarray(y), B),
        tmod.recover(torch.from_numpy(q), torch.from_numpy(y), B))
    _eq(jmod.local_bias(jnp.asarray(q), jnp.asarray(y), B),
        tmod.local_bias(torch.from_numpy(q), torch.from_numpy(y), B))


@pytest.mark.parametrize("seed", [0, 1, 0xDEADBEEF, 0xFFFFFFFF])
def test_counter_hash_bitwise(seed):
    idx = np.concatenate([np.arange(70000, dtype=np.uint64),
                          np.arange(2 ** 32 - 5000, 2 ** 32, dtype=np.uint64),
                          np.array([2 ** 31, 2 ** 31 - 1], np.uint64)])
    ref = jq._counter_uniform(jnp.uint32(seed),
                              jnp.asarray(idx.astype(np.uint32)))
    out = tq._counter_uniform(seed, torch.from_numpy(idx.astype(np.int64)))
    _eq(ref, out)
    assert float(out.min()) >= 0.0 and float(out.max()) < 1.0


@pytest.mark.parametrize("bits", BITS)
def test_pack_unpack_bitwise(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2 ** bits, size=(3, 37)).astype(np.uint8)
    packed = tq.pack_codes(torch.from_numpy(codes), bits)
    _eq(jq.pack_codes(jnp.asarray(codes), bits), packed)
    _eq(jq.unpack_codes(jnp.asarray(np.asarray(packed)), bits, 37),
        tq.unpack_codes(packed, bits, 37))
    assert packed.shape[-1] == tq.packed_last_dim(37, bits)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("stochastic", [True, False])
def test_encode_ref_bitwise(bits, stochastic):
    """ref.encode_ref on a byte-aligned array, idx_base != 0."""
    rng = np.random.default_rng(10 + bits)
    x = (rng.standard_normal((6, 64)) * 2).astype(np.float32)
    jB, tB = _B(bits, stochastic)
    ref = jref.encode_ref(jnp.asarray(x), jB, bits, stochastic, 1234,
                          idx_base=777)
    out = tref.encode_ref(torch.from_numpy(x), tB, bits, stochastic, 1234,
                          idx_base=777)
    _eq(ref, out)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_stacked_payload_bitwise(bits, stochastic, dtype):
    """The encode wrapper on [n, rows, ragged cols] (idx_base != 0) against
    ops.moniqua_encode_jnp, per worker, as the reference engine calls it."""
    rng = np.random.default_rng(20 + bits)
    x32 = (rng.standard_normal((3, 5, 29)) * 3).astype(np.float32)
    tspec, jspec = _spec(bits, stochastic)
    jB, tB = _B(bits, stochastic)
    seed, base = 0x9E37, 5003
    xt = torch.from_numpy(x32).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    out = tenc.encode(xt, tB, seed, bits=bits, stochastic=stochastic,
                      idx_base=base)
    assert out.shape == (3, 5, tq.packed_last_dim(29, bits))
    for w in range(3):
        ref = jops.moniqua_encode_jnp(xj[w], jB, jspec, jnp.uint32(seed),
                                      idx_base=base)
        _eq(ref, out[w])
    stacked = tops.moniqua_encode_stacked(xt, tB, tspec, seed, idx_base=base)
    _eq(jops.moniqua_encode_stacked(xj, jB, jspec, jnp.uint32(seed),
                                    backend="jnp", idx_base=base), stacked)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_reduce_bitwise(bits, m, dtype):
    """The decode-reduce wrapper against ops.moniqua_decode_reduce_jnp on
    random payloads, a ragged last dim and values that wrap mod B."""
    rng = np.random.default_rng(30 + bits + m)
    n, rows, cols = 4, 3, 21
    pc = tq.packed_last_dim(cols, bits)
    ps = rng.integers(0, 256, (n, rows, pc)).astype(np.uint8)
    pn = rng.integers(0, 256, (m, n, rows, pc)).astype(np.uint8)
    y = (rng.standard_normal((n, rows, cols)) * 4).astype(np.float32)
    weights = tuple(rng.uniform(0.05, 0.3, m))
    tspec, jspec = _spec(bits, bits > 1)
    jB, tB = _B(bits, bits > 1)
    yt = torch.from_numpy(y).to(getattr(torch, dtype))
    yj = jnp.asarray(yt.float().numpy()).astype(getattr(jnp, dtype))
    out = tdr.decode_reduce(torch.from_numpy(ps), torch.from_numpy(pn), yt,
                            tB, bits=bits, weights=weights)
    assert out.dtype == yt.dtype and out.shape == yt.shape
    ref = jops.moniqua_decode_reduce_stacked(
        jnp.asarray(ps), jnp.asarray(pn), yj, jB, weights, jspec,
        backend="jnp")
    _eq(ref.astype(jnp.float32), out.float())


def test_wrappers_reject_bad_input():
    x = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError):
        tenc.encode(x, torch.tensor(1.0), 0, bits=3, stochastic=False)
    with pytest.raises(ValueError):
        tenc.encode(x[0], torch.tensor(1.0), 0, bits=8, stochastic=False)
    with pytest.raises(TypeError):
        tenc.encode(x.double(), torch.tensor(1.0), 0, bits=8,
                    stochastic=False)
    p = torch.zeros(2, 3, 8, dtype=torch.uint8)
    with pytest.raises(ValueError):
        tdr.decode_reduce(p, p[None, :, :, :4], x, torch.tensor(1.0),
                          bits=8, weights=(0.5,))


@pytest.mark.parametrize("bits", BITS)
def test_point_decode_ref_bitwise(bits):
    """ref.decode_ref (line 5) and ref.decode_self_ref (line 4)."""
    rng = np.random.default_rng(40 + bits)
    packed = rng.integers(0, 256, (4, 16)).astype(np.uint8)
    y = (rng.standard_normal((4, 16 * 8 // bits)) * 3).astype(np.float32)
    jB, tB = _B(bits, bits > 1)
    pt, yt = torch.from_numpy(packed), torch.from_numpy(y)
    _eq(jref.decode_ref(jnp.asarray(packed), jnp.asarray(y), jB, bits),
        tref.decode_ref(pt, yt, tB, bits))
    _eq(jref.decode_self_ref(jnp.asarray(packed), jnp.asarray(y), jB, bits),
        tref.decode_self_ref(pt, yt, tB, bits))


@pytest.mark.parametrize("mode", ["constant", "theory"])
def test_theta_schedule_matches_reference(mode):
    from repro.core.theta import ThetaSchedule as JTheta
    from repro.core.theta import theta_dpsgd as j_theta_dpsgd
    from repro_torch.core.theta import ThetaSchedule as TTheta
    from repro_torch.core.theta import theta_dpsgd as t_theta_dpsgd
    kw = dict(mode=mode, value=1.5, n=8, rho=0.8)
    for g_inf in (0.0, 0.37, 4.0):
        ref = float(JTheta(**kw)(0.1, jnp.float32(g_inf)))
        out = float(TTheta(**kw)(0.1, torch.tensor(g_inf)))
        assert out == pytest.approx(ref, rel=1e-6)
    assert t_theta_dpsgd(0.1, 2.0, 8, 0.5) == j_theta_dpsgd(0.1, 2.0, 8, 0.5)


# ---------------------------------------------------------------------------
# Rows too long for one launch: column windows (ops._MAX_COLS lowered)
# ---------------------------------------------------------------------------

SPLIT_COLS = 300            # the lowered limit: rows of 700 take 3 windows
SPLIT_BASE = 2 ** 32 - 1500  # the counter wraps inside the first row


def _split_case(bits, seed):
    rng = np.random.default_rng(seed)
    n, rows, cols = 2, 3, 700
    x = (rng.standard_normal((n, rows, cols)) * 3).astype(np.float32)
    pc = tq.packed_last_dim(cols, bits)
    pn = rng.integers(0, 256, (2, n, rows, pc)).astype(np.uint8)
    return x, pn


class _Count:
    """Wraps a kernel wrapper and counts its calls (launches on the card)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("bits", [1, 8])
def test_row_split_encode_and_decode_reduce_bitwise(bits, monkeypatch):
    """With the limit lowered, a row of 700 columns goes in windows cut at
    multiples of values-per-byte, each launched at its own counter base;
    the payload and the mix equal one launch over the row and the
    reference's kernels in interpret mode, bit for bit, with the counter
    wrapping past 2^32 inside the row."""
    x, pn_np = _split_case(bits, 50 + bits)
    tspec, jspec = _spec(bits, True)
    jB, tB = _B(bits, True)
    seed = 0x5EED
    xt = torch.from_numpy(x)
    whole = tenc.encode(xt, tB, seed, bits=bits, stochastic=True,
                        idx_base=SPLIT_BASE)
    weights = (0.25, 0.3)
    pn = torch.from_numpy(pn_np)
    mixed = tdr.decode_reduce(whole, pn, xt, tB, bits=bits, weights=weights)

    enc, dr = _Count(tenc.encode), _Count(tdr.decode_reduce)
    monkeypatch.setattr(tops, "_MAX_COLS", SPLIT_COLS)
    monkeypatch.setattr(tops._enc, "encode", enc)
    monkeypatch.setattr(tops._dr, "decode_reduce", dr)
    split = tops.moniqua_encode_stacked(xt, tB, tspec, seed,
                                        idx_base=SPLIT_BASE)
    split_mix = tops.moniqua_decode_reduce_stacked(whole, pn, xt, tB,
                                                   weights, tspec)
    windows = len(tops._windows(700, tspec.values_per_byte))
    assert windows == 3
    assert enc.calls == dr.calls == 2 * 3 * windows
    assert torch.equal(split, whole)
    assert torch.equal(split_mix, mixed)

    ref = jops.moniqua_encode_stacked(jnp.asarray(x), jB, jspec,
                                      jnp.uint32(seed), backend="pallas",
                                      idx_base=jnp.uint32(SPLIT_BASE))
    _eq(ref, split)
    ref_mix = jops.moniqua_decode_reduce_stacked(
        jnp.asarray(np.asarray(split)), jnp.asarray(pn_np), jnp.asarray(x),
        jB, weights, jspec, backend="pallas")
    _eq(ref_mix, split_mix)
    # rows below the limit keep one launch
    tops.moniqua_encode_stacked(xt[..., :SPLIT_COLS - 1], tB, tspec, seed)
    assert enc.calls == 2 * 3 * windows + 1


@pytest.mark.parametrize("bits", [1, 8])
@pytest.mark.parametrize("mode", ["remote", "self"])
def test_row_split_point_decode_bitwise(bits, mode, monkeypatch):
    """The point decode through the same windows equals one launch over
    the rows and the reference's eager ``ref.py`` decode, bit for bit, and
    its interpret-mode kernel within the 2 ulp of ``|y| + B`` that its
    contracted multiply-adds cost (``tests/test_torch_decode.py``)."""
    x, pn_np = _split_case(bits, 60 + bits)
    tspec, _ = _spec(bits, bits > 1)
    jB, tB = _B(bits, bits > 1)
    packed = torch.from_numpy(pn_np[0])
    fn = getattr(tops, f"moniqua_decode_{mode}")
    whole = fn(packed, torch.from_numpy(x), tB, tspec)
    monkeypatch.setattr(tops, "_MAX_COLS", SPLIT_COLS)
    split = fn(packed, torch.from_numpy(x), tB, tspec)
    assert torch.equal(split, whole)
    ref_fn = jref.decode_ref if mode == "remote" else jref.decode_self_ref
    pad = pn_np.shape[-1] * (8 // bits) - x.shape[-1]
    y = np.pad(x, ((0, 0), (0, 0), (0, pad)))
    ref = ref_fn(jnp.asarray(pn_np[0]), jnp.asarray(y), jB, bits)
    _eq(np.asarray(ref)[..., :x.shape[-1]], split)
    _, jspec = _spec(bits, bits > 1)
    kern = np.asarray(getattr(jops, f"moniqua_decode_{mode}")(
        jnp.asarray(pn_np[0]), jnp.asarray(x), jB, jspec, interpret=True))
    tol = 2 * np.spacing(np.abs(x) + np.float32(jB))
    assert np.all(np.abs(split.numpy() - kern) <= tol)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("stochastic", [True, False])
def test_row_stride_shard_codes_are_the_whole_leafs(bits, stochastic):
    """A stacked leaf split on one dim, as the tensor-parallel round splits
    it (``tensor_parallel.split_view``): each shard encoded with the
    whole leaf's counter offset and row stride gives the codes the
    reference's ``encode_ref`` gives the whole leaf at the same elements,
    on every dim, 2 and 4 shards, also with counters that wrap past 2^32;
    the wrapper (its plain version on the CPU) equals ``encode_plain``."""
    from repro_torch.comm import tensor_parallel as TP
    rng = np.random.default_rng(40 + bits)
    x = (rng.standard_normal((2, 4, 8, 32)) * 3).astype(np.float32)
    jB, tB = _B(bits, stochastic)
    seed = 0xBEEF
    for base in (5003, 2 ** 32 - 700):
        whole = torch.from_numpy(np.stack([np.asarray(jref.unpack_ref(
            jref.encode_ref(jnp.asarray(x[w]), jB, bits, stochastic, seed,
                            idx_base=base), bits)) for w in range(2)]))
        for d in (1, 2, 3):
            for m in (2, 4):
                for r in range(m):
                    s = TP.shard(torch.from_numpy(x), d, r, m)
                    view, off, stride, _, _ = TP.split_view(
                        s, ((d, r * s.shape[d], x.shape[d]),))
                    kw = dict(bits=bits, stochastic=stochastic,
                              idx_base=base + off, idx_row_stride=stride)
                    p = tenc.encode_plain(view, tB, seed, **kw)
                    assert torch.equal(tenc.encode(view, tB, seed, **kw), p)
                    codes = tq.unpack_codes(p, bits, view.shape[-1])
                    want = TP.shard(whole, d, r, m).to(codes.dtype)
                    assert torch.equal(codes.reshape(s.shape), want), \
                        (base, d, m, r)
    # the default stride is the padded row: the whole leaf's own layout
    xt = torch.from_numpy(x).reshape(2, 32, 32)
    assert torch.equal(
        tenc.encode_plain(xt, tB, seed, bits=bits, stochastic=stochastic,
                          idx_base=9),
        tenc.encode_plain(xt, tB, seed, bits=bits, stochastic=stochastic,
                          idx_base=9, idx_row_stride=32))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("layout", ["wq", "wo", "embed"])
def test_block_index_shard_codes_are_the_whole_leafs(bits, stochastic,
                                                     layout):
    """A stacked leaf split on two dims, as the FSDP + tensor-parallel
    round splits it (``tensor_parallel.split_view``: ``wq`` ``[n, L,
    d/D, h/M, hd]``, ``wo`` ``[n, L, h/M, hd, d/D]``, ``embed`` ``[n,
    V/M, d/D]``): each shard encoded with the whole leaf's counter offset,
    row stride and blocks of rows gives the codes the reference's
    ``encode_ref`` gives the whole leaf at the same elements, also with
    counters that wrap past 2^32; the wrapper equals ``encode_plain``, and
    the default blocks (one of every row) are today's index."""
    from repro_torch.comm import tensor_parallel as TP
    shape, (a, b) = {"wq": ((2, 3, 8, 4, 16), (2, 3)),
                     "wo": ((2, 3, 4, 8, 16), (2, 4)),
                     "embed": ((2, 16, 32), (1, 2))}[layout]
    rng = np.random.default_rng(60 + bits)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    jB, tB = _B(bits, stochastic)
    seed = 0xF5D9
    last = shape[-1]
    for base in (7001, 2 ** 32 - 900):
        whole = torch.from_numpy(np.stack([np.asarray(jref.unpack_ref(
            jref.encode_ref(jnp.asarray(x[w].reshape(-1, last)), jB, bits,
                            stochastic, seed, idx_base=base), bits))
            for w in range(2)])).reshape(shape)
        for ma, mb in ((2, 2), (2, 4)):
            for ra in range(ma):
                for rb in range(mb):
                    s = TP.shard(TP.shard(torch.from_numpy(x), a, ra, ma),
                                 b, rb, mb)
                    view, off, stride, rpb, bs = TP.split_view(
                        s, ((a, ra * s.shape[a], shape[a]),
                            (b, rb * s.shape[b], shape[b])))
                    kw = dict(bits=bits, stochastic=stochastic,
                              idx_base=base + off, idx_row_stride=stride,
                              rows_per_block=rpb, block_stride=bs)
                    p = tenc.encode_plain(view, tB, seed, **kw)
                    assert torch.equal(tenc.encode(view, tB, seed, **kw), p)
                    assert torch.equal(tops.moniqua_encode_stacked(
                        view, tB, tq.QuantSpec(bits=bits,
                                               stochastic=stochastic),
                        seed, **{k: v for k, v in kw.items()
                                 if k not in ("bits", "stochastic")}), p)
                    codes = tq.unpack_codes(p, bits, view.shape[-1])
                    want = TP.shard(TP.shard(whole, a, ra, ma), b, rb, mb)
                    assert torch.equal(codes.reshape(s.shape),
                                       want.to(codes.dtype)), \
                        (base, ma, mb, ra, rb)
    # one block of every row, with any stride between blocks, is the
    # index without blocks
    xt = torch.from_numpy(x).reshape(2, -1, last)
    rows = xt.shape[1]
    plain = tenc.encode_plain(xt, tB, seed, bits=bits,
                              stochastic=stochastic, idx_base=9)
    for rpb, bs in ((None, 0), (rows, 0), (rows, 12345)):
        assert torch.equal(tenc.encode_plain(
            xt, tB, seed, bits=bits, stochastic=stochastic, idx_base=9,
            rows_per_block=rpb, block_stride=bs), plain)
