"""qwen2-72b [dense] — GQA kv=8, QKV bias [arXiv:2407.10671].

The reference's ``repro.configs.qwen2_72b``, field for field."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1000000.0,
    gated_mlp=True, long_context_window=8192,
    dist_mode="hierarchical",
    source="arXiv:2407.10671",
)
