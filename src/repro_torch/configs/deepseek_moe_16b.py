"""DeepSeekMoE-16B [arXiv:2401.06066; hf] — fine-grained MoE, 2 shared + 64
routed top-6 experts; first layer dense (d_ff 10944).

Copy of ``repro.configs.deepseek_moe_16b`` (the fields the port reads)."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, kv_heads=16, d_ff=1408,
    vocab=102400, head_dim=128, activation="silu_glu",
    pattern=("dense_first",) + ("moe",) * 27,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, expert_d_ff=1408,
                  first_dense_layers=1, dense_d_ff=10944),
    skip_shapes=(("long_500k", "skip(full-attn)"),),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        n_layers=3, d_model=128, n_heads=4, kv_heads=4, head_dim=32,
        d_ff=64, vocab=512,
        pattern=("dense_first", "moe", "moe"),
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=2, expert_d_ff=64,
                      first_dense_layers=1, dense_d_ff=256))
