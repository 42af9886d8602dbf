"""Synthetic data and objectives (no datasets ship with the repo).

``TokenTask`` is learnable LM data: token streams from a fixed random
bigram teacher, which a model can fit well below the uniform entropy.
``cifar_like`` draws class-conditional Gaussian "images" (32x32x3 NHWC, 10
classes), the stand-in for CIFAR10 in the paper-faithful ResNet runs.  It is
a pure function of ``(seed, step, worker)``: each call seeds its own
``torch.Generator``, so batches are deterministic and resumable.  The draws
differ from the reference's ``jax.random`` streams; tests that compare the
two frameworks hand both the same numpy batches.  ``quadratic_grad`` is the
stochastic gradient of Theorem 1's quadratic, with its noise handed in.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


def _generator(*words: int) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(words)).generate_state(1)[0])
    return torch.Generator().manual_seed(seed)


@dataclasses.dataclass(frozen=True)
class TokenTask:
    """Bigram LM data (the reference's ``TokenTask``): a teacher of
    ``[V, V]`` float32 transition logits, standard normal times 2, fixed by
    ``seed``; each sequence starts at a uniform token and draws every next
    token from the softmax of the teacher's row for the current one.

    The teacher is ``V^2`` float32 values, so this is for small
    vocabularies only: at a published vocabulary of 128,256 it would take
    66 GB.  Drawn with ``torch.Generator``s on the CPU in place of
    ``jax.random``, so the bits differ from the reference's."""
    vocab_size: int
    seed: int = 0

    def teacher(self) -> torch.Tensor:
        """The ``[V, V]`` transition logits (row: current token)."""
        return torch.randn((self.vocab_size, self.vocab_size),
                           generator=_generator(self.seed)) * 2.0

    def batch(self, step: int, batch: int, seq: int, *, device="cuda"
              ) -> Dict[str, torch.Tensor]:
        """``tokens, labels [batch, seq]`` int32, deterministic in
        ``(seed, step)``: ``labels[:, t]`` is the token drawn after
        ``tokens[:, t]``, and ``tokens[:, t + 1] == labels[:, t]``."""
        dev = resolve_device(device)
        probs = torch.softmax(self.teacher(), dim=-1)
        g = _generator(self.seed + 1, step)
        toks = [torch.randint(0, self.vocab_size, (batch,), generator=g)]
        for _ in range(seq):
            toks.append(torch.multinomial(probs[toks[-1]], 1,
                                          generator=g)[:, 0])
        stream = torch.stack(toks, dim=1).int().to(dev)
        return {"tokens": stream[:, :-1].contiguous(),
                "labels": stream[:, 1:].contiguous()}


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
