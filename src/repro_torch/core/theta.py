"""A-priori consensus bounds ``theta`` and quantizer settings from the theory.

The paper's convergence theorems prescribe, per algorithm:

* Theorem 2 (D-PSGD):   theta_k = 2 a_k G_inf C_a log(16 n) / (1 - eta rho)
                        delta  = (1-eta rho) / (8 C_a^2 eta log(16 n) + 2 (1-eta rho))
* Theorem 3 (1-bit):    slack matrix W_bar = gamma W + (1-gamma) I with
                        gamma = 2 / ((1-rho) + 16 d2 * 64 log(4n) log(K) / (1-rho)),
                        d2 = delta^2/(1-2 delta)^2 ;  theta = 2 a G log(16n)/(gamma (1-rho))
* Theorem 4 (D^2):      theta = (6 D1 n + 8) a G_inf ;  delta = 1/(12 n D2 + 2)
* Theorem 5 (AD-PSGD):  theta = 16 t_mix a G_inf     ;  delta = 1/(64 t_mix + 2)

plus the dimension-free bits bound (Sec. 4)

    B <= ceil(log2(4 log2(16 n) / (1 - rho) + 3)).

In practice (paper Sec. 6) a constant theta (they used 2.0) works.  The
formulas are numpy only, the port's own copy of ``repro.core.theta``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.topology import Topology


def theta_dpsgd(alpha: float, g_inf, n: int, rho: float,
                c_alpha: float = 1.0, eta: float = 1.0):
    """Theorem 2 theta_k (constant step size => C_a = eta = 1)."""
    return 2.0 * alpha * g_inf * c_alpha * np.log(16.0 * n) / (1.0 - eta * rho)


def delta_dpsgd(n: int, rho: float, c_alpha: float = 1.0,
                eta: float = 1.0) -> float:
    gap = 1.0 - eta * rho
    return gap / (8.0 * c_alpha ** 2 * eta * np.log(16.0 * n) + 2.0 * gap)


def bits_bound(n: int, rho: float) -> int:
    """Sec. 4 'Bound on the Bits': independent of the model dimension d."""
    return int(np.ceil(np.log2(4.0 * np.log2(16.0 * n) / (1.0 - rho) + 3.0)))


def gamma_slack(delta: float, n: int, K: int, rho: float) -> float:
    """Theorem 3's averaging ratio gamma for extreme bit budgets."""
    d2 = delta ** 2 / (1.0 - 2.0 * delta) ** 2
    denom = ((1.0 - rho) + 16.0 * d2 * 64.0 * np.log(4.0 * n)
             * np.log(max(K, 2)) / (1.0 - rho))
    return min(1.0, 2.0 / denom)


def theta_slack(alpha: float, g_inf: float, n: int, rho: float,
                gamma: float) -> float:
    return 2.0 * alpha * g_inf * np.log(16.0 * n) / (gamma * (1.0 - rho))


def _d2_constants(topo: Topology) -> Tuple[float, float]:
    """D1, D2 of Lemma 12 (they depend only on the eigenvalues of W)."""
    ev = np.sort(np.linalg.eigvalsh(topo.matrix))
    lam2 = float(ev[-2]) if topo.n > 1 else 0.0
    lam_n = float(ev[0])
    lam2 = min(max(lam2, 0.0), 1.0 - 1e-9)
    if lam_n <= -1.0 / 3.0 + 1e-12:
        raise ValueError(f"D^2 requires lambda_n > -1/3, got {lam_n} "
                         f"(use a lazier W, e.g. slack matrix)")
    vn = lam_n - np.sqrt(lam_n ** 2 - lam_n) if lam_n < 0 else 0.0
    avn = abs(vn)
    d1 = max(avn + 2 * abs(lam_n) / (1 - avn) if avn < 1 else np.inf,
             np.sqrt(lam2 / (1 - lam2)) + 2 * lam2 / (1 - lam2))
    d2 = max(2.0 / (1 - avn), 2.0 / np.sqrt(1 - lam2))
    return float(d1), float(d2)


def theta_d2(alpha: float, g_inf: float, topo: Topology) -> float:
    d1, _ = _d2_constants(topo)
    return (6.0 * d1 * topo.n + 8.0) * alpha * g_inf


def delta_d2(topo: Topology) -> float:
    _, d2 = _d2_constants(topo)
    return 1.0 / (12.0 * topo.n * d2 + 2.0)


def theta_adpsgd(alpha: float, g_inf: float, t_mix: float) -> float:
    return 16.0 * t_mix * alpha * g_inf


def delta_adpsgd(t_mix: float) -> float:
    return 1.0 / (64.0 * t_mix + 2.0)


@dataclasses.dataclass
class ThetaSchedule:
    """Runtime theta policy.

    mode:
      "constant" -- fixed ``value`` (paper Sec. 6 used 2.0 throughout).
      "theory"   -- Theorem-2 expression from the tracked ``g_inf`` estimate
                    (a tensor on the training device, so theta is one too).
    """
    mode: str = "constant"
    value: float = 2.0
    n: int = 8
    rho: float = 0.99
    c_alpha: float = 1.0
    eta: float = 1.0

    def __call__(self, alpha: float, g_inf):
        if self.mode == "constant":
            return self.value
        if self.mode == "theory":
            g = torch.clamp_min(torch.as_tensor(g_inf, dtype=torch.float32),
                                1e-8)
            return theta_dpsgd(alpha, g, self.n, self.rho,
                               self.c_alpha, self.eta)
        raise ValueError(f"unknown theta mode {self.mode!r}")
