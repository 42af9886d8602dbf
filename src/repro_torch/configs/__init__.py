"""Architecture registry of the port.  ``get_config(name)``.

It holds only what the port runs.  Every other architecture of the
reference's registry (``repro.configs``) raises with the ROADMAP item that
ports it.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, InputShape, INPUT_SHAPES,
                                      get_input_shape)

ARCH_MODULES = {
    "chatglm3-6b": "chatglm3_6b",
    "llama3.2-3b": "llama3_2_3b",
    "internlm2-20b": "internlm2_20b",
    "qwen2-72b": "qwen2_72b",
    "dbrx-132b": "dbrx_132b",
    "grok-1-314b": "grok_1_314b",
    "zamba2-1.2b": "zamba2_1_2b",
    # the paper's own experimental model (Sec. 6, CIFAR10)
    "resnet20": "resnet20",
}

# architectures of the reference not ported yet -> the ROADMAP item
UNPORTED = {
    "xlstm-125m": "ROADMAP Queue 1 #12 (xlstm)",
    "whisper-base": "ROADMAP Queue 1 #12 (whisper)",
    "phi-3-vision-4.2b": "ROADMAP Queue 1 #12 (vlm)",
}


def get_config(name: str) -> ArchConfig:
    if name in UNPORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet: "
                                  f"{UNPORTED[name]}")
    if name not in ARCH_MODULES:
        raise ValueError(f"unknown arch {name!r}; available: "
                         f"{sorted(ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[name]}").CONFIG


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "get_input_shape",
           "get_config"]
