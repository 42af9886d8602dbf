"""Modulo arithmetic underlying Moniqua (paper Lemma 1 & 2).

Centered modulo: for ``a > 0``, ``z mod a`` is the unique element of
``{z + n a | n in Z}`` in ``[-a/2, a/2)``.  If ``|x - y| < theta <= a/2``
then ``x = ((x mod a) - (y mod a)) mod a + y`` (Lemma 1).  Moniqua sends
``Q_delta((x / B) mod 1)`` with ``B = 2 theta / (1 - 2 delta)`` and recovers
``x_hat = (Q * B - y) mod B + y``, ``|x_hat - x| <= delta * B`` (Lemma 2).

Every function here is the same sequence of float32 operations as the
reference, one PyTorch op each: no fused multiply-add, so results are bit
for bit those of ``repro.core.modulo``.
"""
from __future__ import annotations

import numpy as np
import torch


def _scalar(a, like: torch.Tensor) -> torch.Tensor:
    """``a`` as a 0-dim float32 tensor on ``like``'s device.  A divisor must
    live on the dividend's device: CUDA turns division by a CPU scalar into
    a multiply by its reciprocal, which is not the same float."""
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def cmod(z: torch.Tensor, a) -> torch.Tensor:
    """Centered modulo into ``[-a/2, a/2)`` (Eq. 1): ``z - a*floor(z/a + 1/2)``,
    so the half-open edge is exact: ``cmod(a/2) == -a/2``."""
    zf = z.float()
    a = _scalar(a, zf)
    return zf - a * torch.floor(zf / a + 0.5)


def mod_unit(z: torch.Tensor) -> torch.Tensor:
    """``z mod 1`` into ``[-1/2, 1/2)``: the rescaled payload domain."""
    return cmod(z, 1.0)


def b_theta(theta, delta: float, device=None) -> torch.Tensor:
    """``B_theta = 2 theta / (1 - 2 delta)`` (requires delta < 1/2).

    The reference multiplies an f32 ``theta`` by a weakly typed Python
    float, which JAX rounds to f32 first; the factor is rounded the same
    way here.  Returns a 0-dim float32 tensor (on ``theta``'s device when
    ``theta`` is a tensor, else on ``device``)."""
    if delta >= 0.5:
        raise ValueError(f"Moniqua requires delta < 1/2, got {delta}")
    if device is None and isinstance(theta, torch.Tensor):
        device = theta.device
    t = torch.as_tensor(theta, dtype=torch.float32, device=device)
    return t * float(np.float32(2.0 / (1.0 - 2.0 * delta)))


def recover(q_times_b: torch.Tensor, y: torch.Tensor, B) -> torch.Tensor:
    """Lemma 1 recovery: ``(q*B - y) mod B + y`` against local reference y."""
    yf = y.float()
    return cmod(q_times_b.float() - yf, B) + yf


def local_bias(q_times_b: torch.Tensor, x_local: torch.Tensor, B
               ) -> torch.Tensor:
    """Algorithm 1 line 4: ``x_hat_ii = q_i*B - (x_i mod B) + x_i``."""
    xf = x_local.float()
    return q_times_b.float() - cmod(xf, B) + xf


def error_bound(theta, delta: float) -> float:
    """Lemma 2: ``|x_hat - x| <= theta * 2 delta / (1 - 2 delta)``."""
    return float(theta) * 2.0 * delta / (1.0 - 2.0 * delta)
