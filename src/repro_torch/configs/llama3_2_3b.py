"""llama3.2-3b [dense] — small llama3, GQA kv=8 [hf:meta-llama/Llama-3.2-1B].

The reference's ``repro.configs.llama3_2_3b``, field for field."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=128256, head_dim=128,
    rope_theta=500000.0,
    gated_mlp=True, long_context_window=8192,
    dist_mode="decentralized",
    source="hf:meta-llama/Llama-3.2-1B (3B variant)",
)
