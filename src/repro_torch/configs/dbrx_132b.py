"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base].

The reference's ``repro.configs.dbrx_132b``, field for field."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352, head_dim=128,
    moe=MoEConfig(num_experts=16, top_k=4),
    gated_mlp=True, sliding_window=0, long_context_window=8192,
    dist_mode="hierarchical",
    source="hf:databricks/dbrx-base",
)
