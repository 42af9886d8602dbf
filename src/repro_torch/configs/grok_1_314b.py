"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1].

The reference's ``repro.configs.grok_1_314b``, field for field."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072, head_dim=128,
    moe=MoEConfig(num_experts=8, top_k=2),
    gated_mlp=True, long_context_window=8192,
    dist_mode="hierarchical",
    source="hf:xai-org/grok-1",
)
