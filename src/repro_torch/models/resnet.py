"""CIFAR ResNet (He et al. 2016) — the paper's own experimental model.

ResNet-{20,110} = 3 stages of n={3,18} basic blocks on 32x32 inputs.  Group
norm replaces batch norm so per-worker statistics stay local.

The parameter tree is the reference's (``repro.models.resnet``) leaf for
leaf: same dict keys, same nesting, conv weights in JAX's HWIO layout and
images in NHWC.  Leaf shapes and order fix the gossip bucket's offsets and
so the payload bits; activations go to NCHW and weights to OIHW only inside
:func:`resnet_logits`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.device import resolve_device


def _conv_init(gen: torch.Generator, kh, kw, cin, cout) -> torch.Tensor:
    fan_in = kh * kw * cin
    return torch.randn((kh, kw, cin, cout), generator=gen) \
        * math.sqrt(2.0 / fan_in)


def _same_pad(size: int, k: int, stride: int):
    """JAX's ``SAME`` padding (low, high) of one spatial dim: the extra
    pixel of an odd total goes to the high side, so a 3x3 stride-2 conv on
    an even input pads (0, 1), where torch's ``padding=1`` pads (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``SAME`` convolution of NCHW ``x`` with an HWIO kernel ``w``."""
    kh, kw = w.shape[0], w.shape[1]
    ph = _same_pad(x.shape[-2], kh, stride)
    pw = _same_pad(x.shape[-1], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride,
                        padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def group_norm(x: torch.Tensor, scale, bias, groups: int = 8,
               eps: float = 1e-5) -> torch.Tensor:
    """Group norm over contiguous channel groups, ``g = min(8, C)``, biased
    variance: the reference's ``group_norm`` on NCHW."""
    return F.group_norm(x, min(groups, x.shape[1]), scale, bias, eps)


def init_block(gen: torch.Generator, cin, cout, stride) -> Dict:
    p = {"c1": _conv_init(gen, 3, 3, cin, cout),
         "g1s": torch.ones(cout), "g1b": torch.zeros(cout),
         "c2": _conv_init(gen, 3, 3, cout, cout),
         "g2s": torch.ones(cout), "g2b": torch.zeros(cout)}
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout)
    return p


def block(p, x, stride):
    h = conv(x, p["c1"], stride)
    h = F.relu(group_norm(h, p["g1s"], p["g1b"]))
    h = conv(h, p["c2"])
    h = group_norm(h, p["g2s"], p["g2b"])
    sc = conv(x, p["proj"], stride) if "proj" in p else x
    return F.relu(h + sc)


def init_resnet(gen: torch.Generator, depth: int = 20, num_classes: int = 10,
                width: int = 16) -> Dict:
    """Random ResNet parameters (on the CPU) drawn from ``gen``."""
    if (depth - 2) % 6:
        raise ValueError(f"ResNet depth must be 6n+2, got {depth}")
    n = (depth - 2) // 6
    p = {"stem": _conv_init(gen, 3, 3, 3, width),
         "stem_s": torch.ones(width), "stem_b": torch.zeros(width),
         "stages": []}
    cin = width
    for s, cout in enumerate([width, 2 * width, 4 * width]):
        stage = []
        for b in range(n):
            stride = 2 if (s > 0 and b == 0) else 1
            stage.append(init_block(gen, cin, cout, stride))
            cin = cout
        p["stages"].append(stage)
    p["fc_w"] = torch.randn((cin, num_classes), generator=gen) / math.sqrt(cin)
    p["fc_b"] = torch.zeros(num_classes)
    return p


def resnet_logits(p, x: torch.Tensor) -> torch.Tensor:
    """x: NHWC [N, 32, 32, 3] -> logits [N, classes]."""
    h = x.permute(0, 3, 1, 2)
    h = F.relu(group_norm(conv(h, p["stem"]), p["stem_s"], p["stem_b"]))
    for s, stage in enumerate(p["stages"]):
        for b, bp in enumerate(stage):
            stride = 2 if (s > 0 and b == 0) else 1
            h = block(bp, h, stride)
    h = torch.mean(h, dim=(2, 3))
    return h @ p["fc_w"] + p["fc_b"]


def resnet_loss(p, batch) -> torch.Tensor:
    logits = resnet_logits(p, batch["images"])
    lp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(lp, 1, batch["labels"][:, None]))


def resnet_accuracy(p, batch) -> torch.Tensor:
    logits = resnet_logits(p, batch["images"])
    return torch.mean((torch.argmax(logits, -1) == batch["labels"]).float())


@dataclasses.dataclass(frozen=True)
class ResNetModel:
    """The ``init``/``loss`` interface ``make_train_step`` reads."""
    depth: int = 20
    width: int = 16
    num_classes: int = 10
    device: str = "cuda"

    def generator(self, seed: int) -> torch.Generator:
        """A CPU ``torch.Generator`` seeded with ``seed``: ResNet weights
        are drawn on the host and moved to the model's device."""
        return torch.Generator().manual_seed(seed)

    def init(self, gen: torch.Generator) -> Dict:
        dev = resolve_device(self.device)
        return tree.map(lambda a: a.to(dev),
                        init_resnet(gen, self.depth, self.num_classes,
                                    self.width))

    def loss(self, params, batch) -> torch.Tensor:
        return resnet_loss(params, batch)

    def param_logical(self) -> Dict:
        """Every leaf of ``init``'s tree whole on each worker: no dim of a
        ResNet is tensor-parallel (the reference gives it no logical
        tree; its mesh runs LMs)."""
        return tree.map(lambda a: (None,) * a.dim(), init_resnet(
            torch.Generator(), self.depth, self.num_classes, self.width))
