"""StableLM-2-12B [hf:stabilityai] — dense, GQA kv=8, head dim 160.

Copy of ``repro.configs.stablelm_12b`` (the fields the port reads)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, kv_heads=8, d_ff=13824,
    vocab=100352, head_dim=160, activation="silu_glu",
    skip_shapes=(("long_500k", "skip(full-attn)"),),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(n_layers=4, d_model=128, n_heads=8, kv_heads=2,
                          head_dim=16, d_ff=256, vocab=512)
