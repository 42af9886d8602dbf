"""The Moniqua codec (paper Algorithm 1, lines 3-5) as a composable module.

``MoniquaCodec`` turns a tensor into a *bit-packed modulo residue* payload
and back.  ``AlgoHyper`` carries its spec into the engine, whose rounds run
the kernels through ``comm/engine.py``; its own methods are the functional
codec (``comm/gossip.py::moniqua_gossip`` gossips with them).

Pipeline (element-wise; Algorithm 1 with ``B = 2 theta / (1 - 2 delta)``):

  encode:   r = (x / B) mod 1  in [-1/2, 1/2)      (modulo.mod_unit)
            c = quant codes of Q_delta(r)           (quantizers.quantize_codes)
            p = bit-pack(c)                         (quantizers.pack_codes)
  decode:   q = unquant(unpack(p)) * B
            x_hat = (q - y) mod B + y               (modulo.recover; y = receiver's model)
  self :    x_hat_ii = q_i - (x_i mod B) + x_i      (modulo.local_bias; line 4)

The payload is ``bits/8`` bytes per parameter and nothing else: no scales,
no error state.

``use_kernels=True`` (the reference's ``use_pallas``) encodes through
``ops.moniqua_encode_stacked`` (the CUDA encode on a card tensor; its
stochastic rounding hashes a uint32 ``seed`` with the element's position in
the tensor, row-major over the padded last dim, as the reference's kernel
encode does) and decodes through ``ops.moniqua_decode_remote`` / ``_self``
(the point-decode kernel), in float32.  The plain path rounds with
uniforms handed in or drawn from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import modulo
from repro_torch.core.quantizers import (QuantSpec, dequantize_codes,
                                         pack_codes, packed_last_dim,
                                         quantize_codes, unpack_codes)


@dataclasses.dataclass(frozen=True)
class MoniquaCodec:
    """Static codec config: the quantizer spec, and whether the codec's own
    methods run the kernels."""
    spec: QuantSpec = QuantSpec()
    use_kernels: bool = False

    @property
    def delta(self) -> float:
        return self.spec.delta

    def b_theta(self, theta, device=None) -> torch.Tensor:
        return modulo.b_theta(theta, self.delta, device)

    # -- encode ------------------------------------------------------------
    def encode(self, x: torch.Tensor, theta,
               uniforms: Optional[torch.Tensor] = None, *,
               seed: Optional[int] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x -> packed uint8 payload ``[..., ceil(last / vpb)]`` (line 3).

        Stochastic rounding: the plain path takes ``uniforms`` shaped like
        ``x`` or draws them from ``generator``; ``use_kernels`` takes the
        hash ``seed`` or draws one from ``generator``."""
        B = self.b_theta(theta, x.device)
        if self.use_kernels:
            from repro_torch.kernels import ops as kops
            if seed is None:
                if self.spec.stochastic and generator is None:
                    raise ValueError("stochastic kernel encode needs seed= "
                                     "or a torch.Generator")
                seed = (kops.NO_KEY_SEED if generator is None else int(
                    torch.randint(0, 2 ** 32, (1,), generator=generator,
                                  device=generator.device).item()))
            last = x.shape[-1] if x.dim() else 1
            p = kops.moniqua_encode_stacked(x.reshape(1, -1, last), B,
                                            self.spec, int(seed))
            return p.reshape(*x.shape[:-1], p.shape[-1])
        r = modulo.mod_unit(x.float() / B)
        codes = quantize_codes(r, self.spec, uniforms, generator=generator)
        return pack_codes(codes, self.spec.bits)

    # -- decode ------------------------------------------------------------
    def payload_value(self, packed: torch.Tensor, theta,
                      last_dim: int) -> torch.Tensor:
        """Unpack + dequantize + rescale: ``q * B`` (the transmitted
        value)."""
        codes = unpack_codes(packed, self.spec.bits, last_dim)
        return dequantize_codes(codes, self.spec) * self.b_theta(
            theta, packed.device)

    def decode(self, packed: torch.Tensor, y: torch.Tensor,
               theta) -> torch.Tensor:
        """Recover a *remote* model against local reference ``y`` (line 5),
        in float32."""
        if self.use_kernels:
            from repro_torch.kernels import ops as kops
            return kops.moniqua_decode_remote(
                packed, y.float(), self.b_theta(theta, y.device), self.spec)
        qb = self.payload_value(packed, theta, y.shape[-1])
        return modulo.recover(qb, y, self.b_theta(theta, y.device))

    def decode_self(self, packed: torch.Tensor, x_local: torch.Tensor,
                    theta) -> torch.Tensor:
        """Sender-side biased reconstruction ``x_hat_ii`` (line 4), in
        float32."""
        if self.use_kernels:
            from repro_torch.kernels import ops as kops
            return kops.moniqua_decode_self(
                packed, x_local.float(), self.b_theta(theta, x_local.device),
                self.spec)
        qb = self.payload_value(packed, theta, x_local.shape[-1])
        return modulo.local_bias(qb, x_local,
                                 self.b_theta(theta, x_local.device))

    # -- accounting --------------------------------------------------------
    def payload_bytes(self, x_shape: tuple) -> int:
        """Bytes on the wire for one tensor (exact packed size)."""
        if not x_shape:
            return 1
        inner = int(np.prod(x_shape[:-1], dtype=np.int64))
        return inner * packed_last_dim(x_shape[-1], self.spec.bits)

    def max_error(self, theta) -> float:
        """Lemma 2 bound on ``|x_hat - x|`` (given ``|x - y| < theta``)."""
        return modulo.error_bound(theta, self.delta)
