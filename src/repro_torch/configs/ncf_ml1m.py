"""NCF on MovieLens-1M (paper §4.4).  MLP family — models/ncf.py.

Copy of ``repro.configs.ncf_ml1m``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="ncf-ml1m", family="mlp",
    n_layers=4, d_model=64, n_heads=0, kv_heads=0, d_ff=0, vocab=0,
    remat=False,
)

N_USERS = 6040
N_ITEMS = 3706
FACTORS = 8


def reduced() -> ArchConfig:
    return CONFIG
