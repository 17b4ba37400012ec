"""Chameleon-34B [arXiv:2405.09818] — early-fusion VLM, VQ image tokens.

Copy of ``repro.configs.chameleon_34b`` (the fields the port reads).  The
modality frontend is a stub, as in the reference: images arrive as VQ
codebook token ids inside the shared 65,536 vocab, so the backbone is a
dense decoder LM over mixed text + image token streams."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, kv_heads=8, d_ff=22016,
    vocab=65536, head_dim=128, activation="silu_glu", frontend="vq_stub",
    skip_shapes=(("long_500k", "skip(full-attn)"),),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(n_layers=4, d_model=128, n_heads=8, kv_heads=2,
                          head_dim=16, d_ff=256, vocab=512)
