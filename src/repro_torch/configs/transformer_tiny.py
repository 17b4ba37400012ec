"""Transformer tiny (paper §4.3): 2 layers, d=128, filter 512, enc-dec.

Copy of ``repro.configs.transformer_tiny``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="transformer-tiny", family="audio",   # enc-dec path
    n_layers=2, d_model=128, n_heads=4, kv_heads=4, d_ff=512,
    vocab=8192, head_dim=32, activation="gelu", norm="ln",
    enc_dec=True, n_enc_layers=2, remat=False,
)


def reduced() -> ArchConfig:
    return CONFIG
