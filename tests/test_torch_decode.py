"""The port's single-payload Moniqua decode against the JAX package.

``ops.moniqua_decode_remote`` / ``_self`` over any ``[..., last]`` with the
packed ``[..., ceil(last / vpb)]`` layout.  On the CPU the port's wrapper
takes its plain version (``moniqua_decode.decode_plain``), the semantics the
CUDA kernel is held to bit for bit on the card.

Two comparisons, on numpy inputs from a seed, at 1/2/4/8 bits, ragged last
dims, float32 and bfloat16:

* bitwise against the reference's eager ``kernels/ref.py`` functions
  (``decode_ref``, ``decode_self_ref``), one float32 op per op;
* against the reference's ``ops.moniqua_decode_*`` (its Pallas kernel in
  interpret mode, under ``jit``).  There XLA contracts ``v * B - y`` (and
  ``qb - ymod``) and ``d - B * floor(.)`` into fused multiply-adds, which
  round once where the kernel's ``_rn`` ops round twice:
  ``test_reference_kernel_contracts_fmas`` shows that an FMA emulation
  reproduces the reference bit for bit.  So the port is held to it within
  2 ulp of ``|y| + B`` in float32 (one rounding of each of the two
  contracted intermediates, each at most ``|y| + B`` in magnitude), and
  within one bfloat16 ulp of the output for bfloat16.
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
from repro_torch.kernels import moniqua_decode as tdec
from repro_torch.kernels import ops as tops

BITS = [1, 2, 4, 8]
SHAPES = [(3, 37), (2, 5, 1003), (64,)]     # 37, 1003: no vpb divides them
MODES = ["remote", "self"]


def _case(bits, shape, seed):
    rng = np.random.default_rng(seed)
    pc = -(-shape[-1] // (8 // bits))
    packed = rng.integers(0, 256, shape[:-1] + (pc,)).astype(np.uint8)
    y = (rng.standard_normal(shape) * 4).astype(np.float32)
    delta = jq.delta_for_bits(bits, bits > 1)
    return (packed, y, jmod.b_theta(2.0, delta),
            tmod.b_theta(2.0, delta, "cpu"),
            jq.QuantSpec(bits, bits > 1), tq.QuantSpec(bits, bits > 1))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_decode_plain_bitwise_vs_reference_ref(bits, shape, mode):
    packed, y, jB, tB, _, tspec = _case(bits, shape, bits)
    out = getattr(tops, f"moniqua_decode_{mode}")(
        torch.from_numpy(packed), torch.from_numpy(y), tB, tspec)
    assert out.dtype == torch.float32 and out.shape == y.shape
    fn = jref.decode_ref if mode == "remote" else jref.decode_self_ref
    codes_cols = packed.shape[-1] * (8 // bits)
    yp = np.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, codes_cols - y.shape[-1])])
    ref = np.asarray(fn(jnp.asarray(packed), jnp.asarray(yp), jB, bits))
    np.testing.assert_array_equal(ref[..., :y.shape[-1]], out.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_decode_matches_reference_kernel(bits, shape, mode, dtype):
    packed, y, jB, tB, jspec, tspec = _case(bits, shape, 10 + bits)
    yt = torch.from_numpy(y).to(getattr(torch, dtype))
    yj = jnp.asarray(yt.float().numpy()).astype(getattr(jnp, dtype))
    out = getattr(tops, f"moniqua_decode_{mode}")(
        torch.from_numpy(packed), yt, tB, tspec)
    assert out.dtype == yt.dtype and out.shape == yt.shape
    ref = np.asarray(getattr(jops, f"moniqua_decode_{mode}")(
        jnp.asarray(packed), yj, jB, jspec, interpret=True
    ).astype(jnp.float32))
    got = out.float().numpy()
    if dtype == "float32":
        tol = 2 * np.spacing(np.abs(y) + np.float32(jB))
    else:
        tol = np.spacing(np.abs(ref).astype(np.float32)) * 2.0 ** 16
    assert np.all(np.abs(got - ref) <= tol), np.max(np.abs(got - ref) / tol)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bits", [4, 8])
def test_reference_kernel_contracts_fmas(bits, mode):
    """The reference's jitted kernel equals an emulation with the two
    multiply-adds fused (one rounding each), bit for bit: the port's
    difference from it is that contraction, nothing else."""
    packed, y, jB, _, jspec, _ = _case(bits, (2, 5, 1003), 20 + bits)
    f32, f64 = np.float32, np.float64
    B = f32(jB)
    cols = y.shape[-1]
    codes = np.asarray(jref.unpack_ref(jnp.asarray(packed), bits)
                       )[..., :cols].astype(f32)
    t = ((codes + f32(0.5)) / f32(2 ** bits) - f32(0.5)).astype(f32)

    def fma(a, b, c):       # a * b + c rounded once (the f64 product is exact)
        return (a.astype(f64) * f64(b) + c.astype(f64)).astype(f32)

    if mode == "remote":
        d = fma(t, B, -y)
        fl = np.floor((d / B).astype(f32) + f32(0.5)).astype(f32)
        emu = (fma(fl, -B, d) + y).astype(f32)
    else:
        fl = np.floor((y / B).astype(f32) + f32(0.5)).astype(f32)
        ymod = fma(fl, -B, y)
        emu = (fma(t, B, -ymod) + y).astype(f32)
    ref = np.asarray(getattr(jops, f"moniqua_decode_{mode}")(
        jnp.asarray(packed), jnp.asarray(y), jB, jspec, interpret=True))
    np.testing.assert_array_equal(ref, emu)


def test_decode_wrapper_rejects_bad_input():
    y = torch.zeros(3, 10)
    p = torch.zeros(3, 10, dtype=torch.uint8)
    B = torch.tensor(1.0)
    with pytest.raises(ValueError):
        tdec.decode(p, y, B, bits=3)
    with pytest.raises(ValueError):
        tdec.decode(p, y, B, bits=8, mode="both")
    with pytest.raises(ValueError):
        tdec.decode(p[:, :4], y, B, bits=8)       # 8 bits: one byte a value
    with pytest.raises(ValueError):
        tdec.decode(p, y[0], B, bits=8)
    with pytest.raises(TypeError):
        tdec.decode(p.int(), y, B, bits=8)
    with pytest.raises(TypeError):
        tdec.decode(p, y.double(), B, bits=8)
    assert tdec.decode(p[:, :5], y, B, bits=4).shape == (3, 10)
