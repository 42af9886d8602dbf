"""resnet20 — the paper's own CIFAR10 model (He et al. 2016), for the
paper-faithful decentralized-training experiments (Sec. 6).  Not part of
the assigned-architecture matrix.

The reference's ``repro.configs.resnet20``, field for field: a registry
entry whose transformer fields are placeholders; the model itself is
``repro_torch.models.resnet``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="resnet20", family="dense",   # placeholder fields; built via models/resnet.py
    num_layers=20, d_model=64, num_heads=1, num_kv_heads=1,
    d_ff=64, vocab_size=10,
    dist_mode="decentralized", dtype="float32",
    source="He et al. 2016; paper Sec. 6",
)
