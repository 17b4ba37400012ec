"""Kimi K2 1T-A32B [arXiv:2501.kimi2; paper-table] — trillion-param MoE,
384 routed experts top-8 + 1 shared; first layer dense.

Copy of ``repro.configs.kimi_k2_1t_a32b`` (the fields the port reads):
GQA kv=8 (not MLA), head dim 128 (64 heads x 128 = 8192, so the q/k/v
projections are rectangular against d_model 7168)."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, kv_heads=8, d_ff=2048,
    vocab=163840, head_dim=128, activation="silu_glu",
    pattern=("dense_first",) + ("moe",) * 60,
    moe=MoEConfig(n_experts=384, top_k=8, n_shared=1, expert_d_ff=2048,
                  first_dense_layers=1, dense_d_ff=18432),
    skip_shapes=(("long_500k", "skip(full-attn)"),),
)


def reduced() -> ArchConfig:
    return CONFIG.replace(
        n_layers=3, d_model=128, n_heads=4, kv_heads=2, head_dim=32,
        d_ff=64, vocab=512,
        pattern=("dense_first", "moe", "moe"),
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, expert_d_ff=64,
                      first_dense_layers=1, dense_d_ff=256))
