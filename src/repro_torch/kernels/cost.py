"""Kernel cost accounting: what a dry run charges for each kernel call.

The dry run (``repro_torch.launch.dryrun``) counts a step's work with
``torch.utils.flop_counter.FlopCounterMode`` and a dispatch-mode tracker of
bytes.  Those see PyTorch's ops, not what a hand-written kernel does inside
one launch, so each kernel wrapper charges its kernel by formula instead:
inside :func:`counting`, every call adds the kernel's own FLOPs (its
floating-point operations per element, counted from the CUDA source, or for
flash attention the two matmuls over the attended pairs, causal work
halved) and bytes (each input read once, each output written once) to the
active :class:`KernelCost`.

The charge is the same on every device.  Under a cost context a ``meta``
tensor gets an empty output of the kernel's shape and dtype
(:func:`meta_output`); outside one it raises, as for any device without the
kernel.  On the CPU the wrapper runs its plain version inside
:func:`plain`, which hides the plain version's ops from the dispatch-mode
counters while a cost context is active, so a kernel is never counted
twice nor through its plain version.  On the card the kernel launches as
always.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes

# float32 operations per element, counted from the kernels' code
ENCODE_OPS = 11                # div add floor sub add mul sub add floor max min
DECODE_OPS = 11                # value (4) + sub + cmod (5) + add


def decode_reduce_ops(m: int) -> int:
    """self: value (4) + cmod (5) + 2; each neighbor: value (4) + sub +
    cmod (5) + add + sub + mul + add; then one add."""
    return 11 + 14 * m + 1


def attended_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs that ``sq`` query rows attend over ``sk`` keys:
    all of them, or under ``causal`` key ``j <= i`` (and ``j > i - window``
    when ``window``), the mask of ``flash_attention.causal_mask``."""
    if not causal:
        return sq * sk
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros_like(i)
    return int(np.clip(hi - lo + 1, 0, None).sum())


@dataclasses.dataclass
class KernelCost:
    """FLOPs, bytes and calls charged by kernel name."""
    flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops[name] = self.flops.get(name, 0.0) + float(flops)
        self.bytes[name] = self.bytes.get(name, 0.0) + float(nbytes)
        self.calls[name] = self.calls.get(name, 0) + 1

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes.values())


_ACTIVE: contextvars.ContextVar[Optional[KernelCost]] = \
    contextvars.ContextVar("repro_torch_kernel_cost", default=None)


@contextlib.contextmanager
def counting(cost: Optional[KernelCost] = None) -> Iterator[KernelCost]:
    """Charge every kernel call inside to ``cost`` (a fresh one by
    default), and let the wrappers take ``meta`` tensors."""
    cost = KernelCost() if cost is None else cost
    token = _ACTIVE.set(cost)
    try:
        yield cost
    finally:
        _ACTIVE.reset(token)


def charge(name: str, flops: float, nbytes: float) -> None:
    """Add one call of kernel ``name`` to the active cost (none: no-op)."""
    cost = _ACTIVE.get()
    if cost is not None:
        cost.add(name, flops, nbytes)


def meta_output(name: str, shape, dtype: torch.dtype) -> torch.Tensor:
    """The empty ``meta`` output of kernel ``name``; outside
    :func:`counting` there is no kernel for ``meta`` and this raises."""
    if _ACTIVE.get() is None:
        raise ValueError(f"no {name} for device meta outside a dry run's "
                         f"cost context (kernels.cost.counting)")
    return torch.empty(shape, dtype=dtype, device="meta")


@contextlib.contextmanager
def plain() -> Iterator[None]:
    """Around a kernel's plain version on the CPU: under a cost context the
    dispatch-mode counters do not see its ops (the kernel was charged by
    formula); otherwise nothing changes."""
    if _ACTIVE.get() is None:
        yield
        return
    with _disable_current_modes():
        yield


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)
