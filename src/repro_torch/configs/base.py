"""Architecture configuration schema (copy of ``repro.configs.base``).

The port keeps its own copy of the fields its serving and training
slices read, so it never imports the JAX package. Field names, defaults
and values match the reference, which lets a JAX config and a port
config describe the same model."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

ARCH_IDS = ("minicpm_2b",)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    activation: str = "silu_glu"
    norm: str = "rms"
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    pattern: Tuple[str, ...] = ()    # () -> ("dense",) * n_layers
    activation_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True               # rematerialize each layer in training
    schedule: str = "cosine"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def resolved_pattern(self) -> Tuple[str, ...]:
        return self.pattern or ("dense",) * self.n_layers

    def n_params(self) -> int:
        """Analytic parameter count of the dense family (embeddings once
        if tied) — the reference's formula restricted to dense blocks."""
        d, ff, hd = self.d_model, self.d_ff, self.resolved_head_dim
        q, kvd = self.n_heads * hd, self.kv_heads * hd
        glu = self.activation.endswith("_glu")
        per_layer = d * q + 2 * d * kvd + q * d + d * ff * (3 if glu else 2)
        total = per_layer * len(self.resolved_pattern)
        return total + self.vocab * d * (1 if self.tie_embeddings else 2)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def _module(arch_id: str):
    arch_id = arch_id.replace("-", "_").replace(".", "p")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown or not yet ported arch {arch_id!r}; "
                       f"ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_reduced_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).reduced()
