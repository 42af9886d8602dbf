"""chatglm3-6b [dense] — RoPE 2d (half-dim rotary), GQA kv=2 [arXiv:2406.12793].

The reference's ``repro.configs.chatglm3_6b``, field for field."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024, head_dim=128,
    rope_fraction=0.5,                 # chatglm applies RoPE to half the dims
    qkv_bias=True,                      # chatglm uses QKV bias
    gated_mlp=True, long_context_window=8192,
    dist_mode="decentralized",
    source="arXiv:2406.12793 (hf:THUDM/chatglm3-6b)",
)
