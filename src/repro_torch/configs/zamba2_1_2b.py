"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242]; ssm_state=64.

The reference's ``repro.configs.zamba2_1_2b``, field for field."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, chunk=128),
    shared_attn_every=6,
    gated_mlp=True, long_context_window=8192,
    dist_mode="decentralized",
    source="arXiv:2411.15242",
)
