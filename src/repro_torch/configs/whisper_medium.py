"""Whisper-medium [arXiv:2212.04356] — enc-dec audio; conv frontend stubbed.

Copy of ``repro.configs.whisper_medium``.  The encoder takes precomputed
frame embeddings [B, S_frames, d_model] (the conv frontend's output); the
decoder's context is the model-native 448 tokens."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, kv_heads=16, d_ff=4096,
    vocab=51865, head_dim=64, activation="gelu", norm="ln",
    enc_dec=True, n_enc_layers=24, frontend="audio_stub",
    skip_shapes=(("long_500k", "skip(full-attn enc-dec; 448-token decoder)"),),
)

DEC_LEN = 448  # whisper's decoder context


def reduced() -> ArchConfig:
    return CONFIG.replace(n_layers=2, n_enc_layers=2, d_model=128, n_heads=4,
                          kv_heads=4, head_dim=32, d_ff=256, vocab=512)
