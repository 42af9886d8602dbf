"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP stub
[hf:microsoft/Phi-3-vision-128k-instruct].

The reference's ``repro.configs.phi_3_vision_4_2b``, field for field."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    vision_tokens=576, vision_embed_dim=1024,
    gated_mlp=True, long_context_window=8192,
    dist_mode="decentralized",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
