"""Moniqua decentralized SGD in PyTorch, with hand-written CUDA kernels.

The port of ``repro`` (JAX + Pallas).  It mirrors that package's layout
(``core/``, ``comm/``, ``kernels/``, ``models/``, ``optim/``, ``data/``,
``train/``) and its names, imports ``torch`` and numpy only, and never
``jax`` or any ``repro`` module.

Entry points take ``device=`` and default to ``"cuda"``; asking for the card
when there is none raises (:func:`repro_torch.device.resolve_device`).  The
codec kernels dispatch on the tensor they are given: a CUDA tensor launches
the CUDA kernel, a CPU tensor takes the kernel's plain PyTorch version.
"""
