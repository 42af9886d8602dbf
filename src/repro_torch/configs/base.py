"""Architecture / run configuration schema: a copy of the reference's
``repro.configs.base`` (the port imports nothing of ``repro``), except for
the default of ``flash_attention``.

``ArchConfig`` fully describes one architecture; each
``repro_torch/configs/<id>.py`` instantiates its published hyper-parameters
(sources cited in the file).  ``reduced()`` produces the CPU test variant
(<= 2 layers, d_model <= 512, <= 4 experts) of the same family.

``InputShape`` describes the four workload shapes of the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 256          # GShard dispatch group length (tokens)
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64            # mamba2 / xlstm recurrent state size
    conv_width: int = 4            # mamba2 local conv
    expand: int = 2                # mamba2 inner expansion
    chunk: int = 128               # chunked-scan length
    # xlstm: indices (mod pattern length) of sLSTM blocks; others mLSTM
    slstm_every: int = 0           # 0 = none (pure mLSTM); k>0 = every k-th


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    # attention
    head_dim: Optional[int] = None           # default d_model // num_heads
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0               # chatglm "2d RoPE": 0.5
    qkv_bias: bool = False                   # qwen2
    sliding_window: int = 0                  # 0 = full attention (training)
    long_context_window: int = 8192          # window used for long_500k decode
    # MLP
    gated_mlp: bool = True                   # SwiGLU-style
    # subconfigs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba): shared attention block every k mamba layers
    shared_attn_every: int = 0
    # audio/vlm stubs
    encoder_layers: int = 0                  # whisper encoder depth
    encoder_downsample: int = 2              # conv frontend stub ratio
    decoder_len_cap: int = 448               # whisper decoder max positions
    vision_tokens: int = 576                 # vlm patch embeddings per image
    vision_embed_dim: int = 1024             # CLIP hidden size (stub output)
    # numerics / distribution
    dtype: str = "bfloat16"
    dist_mode: str = "decentralized"         # or "hierarchical"
    remat: bool = True
    # analysis-only in the reference (its layer scan); the port loops over
    # the layers in Python and ignores it
    unroll_layers: bool = False
    # route self-attention through the flash kernel
    # (repro_torch/kernels/flash_attention.py).  The port's one default
    # that differs from the reference's: there False chose XLA's attention,
    # here it chooses the plain masked-softmax oracle, which holds float32
    # scores [B, H, S, S] (3.2 GB a layer at 2 x 4096); it is asked for by
    # name (flash_attention=False) as the check of the kernel path.
    flash_attention: bool = True
    tie_embeddings: bool = False
    # citation
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, nh, nkv = self.hd, self.num_heads, self.num_kv_heads
        attn = d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
        if self.qkv_bias:
            attn += (nh + 2 * nkv) * hd
        if self.gated_mlp:
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        per_layer = 0
        if self.family in ("dense", "vlm", "audio"):
            per_layer = attn + mlp + 2 * d
        elif self.family == "moe":
            router = d * self.moe.num_experts
            per_layer = attn + self.moe.num_experts * mlp + router + 2 * d
        elif self.family == "ssm":
            # mLSTM block: up(2d) + q,k,v(d^2 each) + down  ~ 6 d^2
            per_layer = 6 * d * d + 2 * d
        elif self.family == "hybrid":
            di = self.ssm.expand * d
            ns = self.ssm.state_dim
            mamba = (d * (2 * di + 2 * ns + self.num_heads)
                     + self.ssm.conv_width * (di + 2 * ns) + di * d)
            per_layer = mamba + d
        layers = per_layer * self.num_layers
        if self.family == "hybrid" and self.shared_attn_every:
            layers += attn + mlp + 2 * d  # one shared attention block
        if self.family == "audio":
            layers += (attn + d * (nh * hd) + (nh * hd) * d + mlp + 3 * d) * self.encoder_layers
        emb = v * d + (0 if self.tie_embeddings else v * d)
        if self.family == "vlm":
            emb += self.vision_embed_dim * d  # projector
        return layers + emb + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp = (3 if self.gated_mlp else 2) * d * f
        inactive = (self.moe.num_experts - self.moe.top_k) * mlp * self.num_layers
        return self.param_count() - inactive

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/wiring, tiny sizes."""
        moe = ssm = None
        if self.moe is not None:
            moe = MoEConfig(num_experts=min(self.moe.num_experts, 4),
                            top_k=min(self.moe.top_k, 2),
                            capacity_factor=self.moe.capacity_factor,
                            group_size=64)
        if self.ssm is not None:
            ssm = SSMConfig(state_dim=min(self.ssm.state_dim, 16),
                            conv_width=self.ssm.conv_width,
                            expand=self.ssm.expand, chunk=32,
                            slstm_every=self.ssm.slstm_every)
        return dataclasses.replace(
            self,
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 4),
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            encoder_layers=min(self.encoder_layers, 2),
            vision_tokens=min(self.vision_tokens, 16),
            vision_embed_dim=min(self.vision_embed_dim, 64),
            dtype="float32",
            remat=False,
            shared_attn_every=2 if self.shared_attn_every else 0,
            moe=moe,
            ssm=ssm,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


def get_input_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
