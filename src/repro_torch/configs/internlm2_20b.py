"""internlm2-20b [dense] — GQA kv=8 [arXiv:2403.17297].

The reference's ``repro.configs.internlm2_20b``, field for field."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92544, head_dim=128,
    rope_theta=1000000.0,
    gated_mlp=True, long_context_window=8192,
    dist_mode="decentralized",
    source="arXiv:2403.17297",
)
