"""Gemma-3-1B [hf:google/gemma-3-1b-pt] — 5:1 local:global, 128k context.

Copy of ``repro.configs.gemma3_1b`` (the fields the port reads).  Five
sliding-window (512) ``local`` layers per ``dense`` (global) layer; a
``local`` layer's decode cache is a ring of ``window`` positions, so
gemma3 serves through the dense-cache ``LMServer`` only (the paged
engine takes global-attention blocks)."""
from repro_torch.configs.base import ArchConfig

_PATTERN = tuple(
    ("local" if (i % 6) != 5 else "dense") for i in range(26)
)

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, kv_heads=1, d_ff=6912,
    vocab=262144, head_dim=256, activation="gelu_glu", tie_embeddings=True,
    pattern=_PATTERN, window=512, rope_theta=1_000_000.0,
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        n_layers=4, d_model=128, n_heads=4, kv_heads=1, head_dim=32,
        d_ff=256, vocab=512, window=64,
        pattern=("local", "local", "dense", "local"))
