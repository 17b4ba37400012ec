"""ResNet-20 on CIFAR-10 (paper §4.2).  Conv family — handled by
models/resnet.py, not the LM stack; ArchConfig fields are nominal.

Copy of ``repro.configs.resnet20_cifar``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="resnet20-cifar", family="conv",
    n_layers=20, d_model=64, n_heads=0, kv_heads=0, d_ff=0, vocab=10,
    remat=False,
)

DEPTH = 20
N_CLASSES = 10


def reduced() -> ArchConfig:
    return CONFIG
