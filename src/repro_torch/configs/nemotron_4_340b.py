"""Nemotron-4-340B [arXiv:2402.16819] — dense, GQA kv=8, squared-ReLU MLP
(no gate: ``w_gate`` and ``w_down`` only), layer norm, head dim 192.

Copy of ``repro.configs.nemotron_4_340b`` (the fields the port reads)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, kv_heads=8, d_ff=73728,
    vocab=256000, head_dim=192, activation="sq_relu", norm="ln",
    skip_shapes=(("long_500k", "skip(full-attn)"),),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(n_layers=4, d_model=128, n_heads=8, kv_heads=2,
                          head_dim=16, d_ff=512, vocab=512)
