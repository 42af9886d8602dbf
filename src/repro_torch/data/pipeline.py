"""Synthetic LM batches, the counterpart of ``repro.data.pipeline``.

``SyntheticLMPipeline.global_batch(step)`` draws the tensors of
``Model.batch_spec``: uniform tokens in ``[0, vocab_size)`` and Gaussian
float inputs; ``worker_batch(step)`` lays the same batch out as the
decentralized trainer reads it, ``[n_workers, GB / n_workers, ...]``.  It
is a pure function of ``(seed, step)``: each call seeds its own
``torch.Generator``.  The draws differ from the reference's ``jax.random``
streams; tests that compare the two frameworks hand both the same numpy
inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import InputShape
from repro_torch.models.model_factory import Model


@dataclasses.dataclass
class SyntheticLMPipeline:
    """Batch factory for one (model, shape, n_workers) combination.
    Batches land on the model's device."""
    model: Model
    shape: InputShape
    n_workers: int
    seed: int = 0

    def _draw(self, step: int) -> Dict[str, torch.Tensor]:
        """The unstacked batch on the host."""
        words = [self.seed, step]
        g = torch.Generator().manual_seed(
            int(np.random.SeedSequence(words).generate_state(1)[0]))
        out = {}
        for name, (shp, dt) in self.model.batch_spec(self.shape).items():
            if dt.is_floating_point:
                out[name] = torch.randn(shp, generator=g).to(dt)
            else:
                out[name] = torch.randint(0, self.model.cfg.vocab_size, shp,
                                          generator=g).to(dt)
        return out

    def global_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Unstacked ``[GB, ...]`` batch."""
        dev = self.model.dev
        return {k: v.to(dev) for k, v in self._draw(step).items()}

    def worker_batch(self, step: int, rows: Optional[Tuple[int, int]] = None,
                     inner: Optional[Tuple[int, int]] = None
                     ) -> Dict[str, torch.Tensor]:
        """Stacked ``[n, GB / n, ...]`` layout for the decentralized
        trainer: worker ``w`` takes rows ``w GB/n .. (w + 1) GB/n - 1`` of
        the global batch.  ``rows = (lo, hi)``: only workers ``[lo, hi)``
        (a rank's block); ``inner = (a, b)``: only rows ``[a, b)`` of each
        worker's batch (the hierarchical rules' ``batch`` on ``data``);
        both cut on the host before the copy to the device; the draws are
        the whole batch's."""
        n = self.n_workers
        dev = self.model.dev
        lo, hi = (0, n) if rows is None else rows

        def stack(a):
            if a.shape[0] % n:
                raise ValueError(f"global batch {a.shape[0]} does not split "
                                 f"over {n} workers")
            a = a.reshape(n, a.shape[0] // n, *a.shape[1:])[lo:hi]
            if inner is not None:
                a = a[:, inner[0]:inner[1]]
            return a.to(dev)
        return {k: stack(v) for k, v in self._draw(step).items()}
