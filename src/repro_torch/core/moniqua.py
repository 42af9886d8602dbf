"""The Moniqua codec's static configuration (paper Algorithm 1).

Here ``MoniquaCodec`` only carries the quantizer spec into ``AlgoHyper``:
the encode and the fused decode-reduce run in ``kernels/`` through
``comm/engine.py``, as they do in the reference's engine.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.quantizers import QuantSpec


@dataclasses.dataclass(frozen=True)
class MoniquaCodec:
    """Quantizer spec of the Moniqua wire."""
    spec: QuantSpec = QuantSpec()

    @property
    def delta(self) -> float:
        return self.spec.delta
