"""xlstm-125m [ssm] — sLSTM + mLSTM blocks, d_ff=0 [arXiv:2405.04517].

The reference's ``repro.configs.xlstm_125m``, field for field."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=192,
    ssm=SSMConfig(state_dim=64, chunk=128, slstm_every=4),  # sLSTM at 0,4,8
    gated_mlp=False, long_context_window=8192,
    dist_mode="decentralized",
    source="arXiv:2405.04517",
)
