"""Synthetic data and objectives (no datasets ship with the repo).

``cifar_like`` draws class-conditional Gaussian "images" (32x32x3 NHWC, 10
classes), the stand-in for CIFAR10 in the paper-faithful ResNet runs.  It is
a pure function of ``(seed, step, worker)``: each call seeds its own
``torch.Generator``, so batches are deterministic and resumable.  The draws
differ from the reference's ``jax.random`` streams; tests that compare the
two frameworks hand both the same numpy batches.  ``quadratic_grad`` is the
stochastic gradient of Theorem 1's quadratic, with its noise handed in.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


def _generator(*words: int) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(words)).generate_state(1)[0])
    return torch.Generator().manual_seed(seed)


def cifar_like(step: int, batch: int, *, num_classes: int = 10, seed: int = 0,
               worker: Optional[int] = None, device="cuda"
               ) -> Dict[str, torch.Tensor]:
    """Class-conditional Gaussian 'images'.  Deterministic in
    ``(seed, step, worker)``."""
    dev = resolve_device(device)
    g = _generator(seed, step, 0 if worker is None else worker + 1)
    # fixed class means and low-rank basis (seed only: same teacher everywhere)
    mus = torch.randn((num_classes, 8), generator=_generator(seed, 777)) * 2.0
    basis = torch.randn((8, 32 * 32 * 3), generator=_generator(seed, 778)) / 8.0
    labels = torch.randint(0, num_classes, (batch,), generator=g)
    signal = (mus[labels] @ basis).reshape(batch, 32, 32, 3)
    noise = torch.randn((batch, 32, 32, 3), generator=g) * 0.5
    return {"images": (signal + noise).to(dev), "labels": labels.to(dev)}


def stacked_cifar_like(step: int, batch: int, n_workers: int, *,
                       seed: int = 0, device="cuda"
                       ) -> Dict[str, torch.Tensor]:
    """One ``cifar_like`` batch per worker, stacked on a leading worker axis
    (``images [n, batch, 32, 32, 3]``, ``labels [n, batch]``)."""
    per = [cifar_like(step, batch, worker=w, seed=seed, device=device)
           for w in range(n_workers)]
    return {k: torch.stack([b[k] for b in per]) for k in per[0]}


def quadratic_grad(x: torch.Tensor, delta: float, noise: torch.Tensor,
                   sigma: float = 0.1) -> torch.Tensor:
    """Stochastic gradient of the Theorem-1 quadratic at ``x``, with the
    standard normal ``noise`` (shaped like ``x``) handed in."""
    opt = delta / 2.0
    return x - opt + sigma * noise
