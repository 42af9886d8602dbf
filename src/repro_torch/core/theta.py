"""A-priori consensus bound ``theta`` (paper Theorem 2 and Sec. 6).

* Theorem 2 (D-PSGD): ``theta_k = 2 a_k G_inf C_a log(16 n) / (1 - eta rho)``.
* In practice (paper Sec. 6) a constant theta (they used 2.0) works.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def theta_dpsgd(alpha: float, g_inf, n: int, rho: float,
                c_alpha: float = 1.0, eta: float = 1.0):
    """Theorem 2 theta_k (constant step size => C_a = eta = 1)."""
    return 2.0 * alpha * g_inf * c_alpha * np.log(16.0 * n) / (1.0 - eta * rho)


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
