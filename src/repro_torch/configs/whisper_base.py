"""whisper-base [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356].

The reference's ``repro.configs.whisper_base``, field for field."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865, head_dim=64,
    rope_fraction=0.0,                  # learned/sinusoidal positions
    encoder_layers=6, encoder_downsample=2, decoder_len_cap=448,
    gated_mlp=False, tie_embeddings=True,
    dist_mode="decentralized",
    source="arXiv:2212.04356",
)
