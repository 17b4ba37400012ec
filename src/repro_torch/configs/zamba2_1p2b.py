"""Zamba2-1.2B [arXiv:2411.15242; hf] — Mamba2 backbone + shared attention.

Copy of ``repro.configs.zamba2_1p2b``.  As in the reference, Zamba2's
single weight-shared attention block applied at several depths is
represented as regular ``attn`` blocks at every 6th position; weight
sharing is a parameter-count detail orthogonal to the S2FP8 numerics and
to the model's compute shape."""
from repro_torch.configs.base import ArchConfig, SSMConfig

_PATTERN = tuple(
    ("attn" if (i % 6) == 5 else "mamba2") for i in range(38)
)

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, kv_heads=32, d_ff=8192,
    vocab=32000, head_dim=64, activation="gelu_glu",
    pattern=_PATTERN,
    ssm=SSMConfig(state=64, expand=2, conv_kernel=4, head_dim=64),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        n_layers=4, d_model=128, n_heads=4, kv_heads=4, head_dim=32,
        d_ff=256, vocab=512,
        pattern=("mamba2", "mamba2", "attn", "mamba2"),
        ssm=SSMConfig(state=8, expand=2, conv_kernel=4, head_dim=32))
