"""Architecture registry of the port.  ``get_config(name)``.

The reference's registry (``repro.configs``), architecture for
architecture.
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
    "xlstm-125m": "xlstm_125m",
    "whisper-base": "whisper_base",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    # the paper's own experimental model (Sec. 6, CIFAR10)
    "resnet20": "resnet20",
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCH_MODULES:
        raise ValueError(f"unknown arch {name!r}; available: "
                         f"{sorted(ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[name]}").CONFIG


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "get_input_shape",
           "get_config"]
