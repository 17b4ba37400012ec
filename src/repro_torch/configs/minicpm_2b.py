"""MiniCPM-2B [arXiv:2404.06395; hf] — dense llama-like, MHA, WSD schedule.

Copy of ``repro.configs.minicpm_2b`` (the fields the port reads)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, kv_heads=36, d_ff=5760,
    vocab=122753, head_dim=64, activation="silu_glu", tie_embeddings=True,
    schedule="wsd",
    skip_shapes=(("long_500k", "skip(full-attn): pure full attention, 500k KV "
                  "decode needs sub-quadratic attention per assignment"),),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(n_layers=4, d_model=128, n_heads=4, kv_heads=4,
                          head_dim=32, d_ff=256, vocab=512)
