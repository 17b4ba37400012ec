"""Falcon-Mamba-7B [arXiv:2410.05355] — pure Mamba-1, attention-free.

Copy of ``repro.configs.falcon_mamba_7b`` (the fields the port reads)."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, kv_heads=0, d_ff=0,
    vocab=65024, activation="silu_glu",
    pattern=("mamba1",) * 64,
    ssm=SSMConfig(state=16, expand=2, conv_kernel=4, dt_rank=256),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        n_layers=4, d_model=128, vocab=512,
        pattern=("mamba1",) * 4,
        ssm=SSMConfig(state=8, expand=2, conv_kernel=4, dt_rank=8))
