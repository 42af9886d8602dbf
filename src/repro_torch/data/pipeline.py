"""Synthetic LM batches, the counterpart of ``repro.data.pipeline``.

``SyntheticLMPipeline.global_batch(step)`` draws the tensors of
``Model.batch_spec``: uniform tokens in ``[0, vocab_size)`` and Gaussian
float inputs.  It is a pure function of ``(seed, step)``: each call seeds
its own ``torch.Generator``.  The draws differ from the reference's
``jax.random`` streams; tests that compare the two frameworks hand both the
same numpy inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import InputShape
from repro_torch.models.model_factory import Model


@dataclasses.dataclass
class SyntheticLMPipeline:
    """Batch factory for one (model, shape) combination.  Batches land on
    the model's device."""
    model: Model
    shape: InputShape
    seed: int = 0

    def global_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Unstacked ``[GB, ...]`` batch."""
        dev = self.model.dev
        words = [self.seed, step]
        g = torch.Generator().manual_seed(
            int(np.random.SeedSequence(words).generate_state(1)[0]))
        out = {}
        for name, (shp, dt) in self.model.batch_spec(self.shape).items():
            if dt.is_floating_point:
                arr = torch.randn(shp, generator=g).to(dt)
            else:
                arr = torch.randint(0, self.model.cfg.vocab_size, shp,
                                    generator=g).to(dt)
            out[name] = arr.to(dev)
        return out

