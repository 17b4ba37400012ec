"""Architecture configuration schema (copy of ``repro.configs.base``).

The port keeps its own copy of the fields its serving and training
slices read, so it never imports the JAX package. Field names, defaults
and values match the reference, which lets a JAX config and a port
config describe the same model.  ``MoEConfig`` and ``SSMConfig`` are the
reference's, verbatim, and so are the block types, the assigned shape
grid (``SHAPES``, ``SHAPE_SPECS``) and each config's ``skip_shapes``."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block types that can appear in a layer pattern:
#   "dense"  : GQA attention + dense MLP
#   "local"  : sliding-window GQA attention + dense MLP
#   "moe"    : GQA attention + MoE MLP (shared + routed experts)
#   "mamba1" : Mamba-1 selective-SSM block
#   "mamba2" : Mamba-2 (SSD, multi-head scalar-decay) block
#   "attn"   : attention-only block (Zamba2 shared attention)
# ---------------------------------------------------------------------------
BLOCK_TYPES = ("dense", "local", "moe", "mamba1", "mamba2", "attn")

ARCH_IDS = ("minicpm_2b", "stablelm_12b", "gemma3_1b", "nemotron_4_340b",
            "zamba2_1p2b", "deepseek_moe_16b", "kimi_k2_1t_a32b",
            "chameleon_34b",
            "falcon_mamba_7b", "whisper_medium",
            # paper-reproduction models
            "transformer_tiny", "resnet20_cifar", "ncf_ml1m")

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

SHAPE_SPECS = {
    # name: (seq_len, global_batch, kind)
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    expert_d_ff: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0              # d_ff of the first dense layer(s)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balancing loss weight
    # "global"  — route over all tokens (baseline; the token gather crosses
    #             data shards -> all-gather of activations)
    # "grouped" — route within each batch row; gathers stay data-local and
    #             only the (much smaller) dispatched xe crosses the expert
    #             axis (hillclimb for the collective-bound MoE cells)
    routing: str = "global"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 16
    expand: int = 2
    conv_kernel: int = 4
    dt_rank: int = 0                 # mamba1; 0 -> d_model // 16
    head_dim: int = 64               # mamba2


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio | mlp | conv
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    activation: str = "silu_glu"     # silu_glu | gelu_glu | gelu | sq_relu
    norm: str = "rms"                # rms | ln
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    pattern: Tuple[str, ...] = ()    # () -> ("dense",) * n_layers
    window: int = 0                  # sliding window for "local" blocks
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (whisper, transformer_tiny): n_layers counts DECODER
    # layers
    enc_dec: bool = False
    n_enc_layers: int = 0
    # vq_stub (chameleon): images arrive as VQ token ids in the shared
    # vocab, so the backbone reads token ids and no model code branches
    # on it
    frontend: str = "none"           # none | audio_stub | vq_stub
    activation_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True               # rematerialize each layer in training
    # attention above 2048 tokens: "naive" (chunked online softmax) or
    # "flash" (Policy.flash_attention: the payload flash node, or the
    # chunked flash attention with a recompute backward)
    attn_impl: str = "naive"
    # SSM scan schedule ("step", "unroll8", "ssd"): the port runs every
    # schedule as its selective-scan kernel (prefill and training), so the
    # field is carried for the configs only
    ssm_impl: str = "step"
    schedule: str = "cosine"
    # which assigned shapes run; others map to a skip reason string
    skip_shapes: Tuple[Tuple[str, str], ...] = ()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def resolved_pattern(self) -> Tuple[str, ...]:
        return self.pattern or ("dense",) * self.n_layers

    @property
    def sub_quadratic(self) -> bool:
        p = set(self.resolved_pattern)
        return bool(p & {"mamba1", "mamba2"}) or (p <= {"local", "dense"}
                                                  and "local" in p)

    def skip_reason(self, shape: str) -> Optional[str]:
        for s, reason in self.skip_shapes:
            if s == shape:
                return reason
        return None

    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        q, kvd = self.n_heads * hd, self.kv_heads * hd
        return 2 * self.d_model * q + 2 * self.d_model * kvd

    def _mlp_params(self, d_ff: int) -> int:
        glu = self.activation.endswith("_glu")
        return self.d_model * d_ff * (3 if glu else 2)

    def _block_params(self, blk: str, experts: int) -> int:
        """Weights of one block with ``experts`` routed experts counted."""
        if blk in ("dense", "local", "attn"):
            return self._attn_params() + self._mlp_params(self.d_ff)
        if blk == "mamba1":
            s, d = self.ssm, self.d_model
            di = s.expand * d
            dtr = s.dt_rank or d // 16
            return (d * 2 * di + di * s.conv_kernel + di * (dtr + 2 * s.state)
                    + dtr * di + di * s.state + di * d)
        if blk == "mamba2":
            s, d = self.ssm, self.d_model
            di = s.expand * d
            nh = di // s.head_dim
            return (d * (2 * di + 2 * s.state + nh) + di * s.conv_kernel
                    + di * d)
        m = self.moe
        if blk == "dense_first":
            return self._attn_params() + self._mlp_params(
                m.dense_d_ff or self.d_ff)
        if blk == "moe":
            return (self._attn_params() + self.d_model * m.n_experts
                    + (experts + m.n_shared) * self._mlp_params(
                        m.expert_d_ff))
        raise NotImplementedError(f"block type {blk!r} is not ported")

    def n_params(self) -> int:
        """Analytic parameter count of the ported block types (embeddings
        once if tied; an encoder-decoder adds its encoder blocks and its
        decoder's cross-attention, as the reference does).  Unlike the reference's formula, which skips them,
        ``dense_first`` blocks are counted, at ``moe.dense_d_ff``.  A
        ``mamba1`` block counts its matrices, the conv kernel and A, as the
        reference does (not its biases, D or norm scale); a ``mamba2``
        block its in and out projections and the conv kernel over the di
        x channels (not the conv's 2n channels of B and C, A, dt's bias, D
        or the norm scales), as the reference does."""
        total = sum(self._block_params(b, self.moe.n_experts if self.moe
                                       else 0)
                    for b in self.resolved_pattern)
        if self.enc_dec:
            # the encoder's blocks and each decoder layer's cross-attention
            total += (self.n_enc_layers * self._block_params("dense", 0)
                      + self.n_layers * self._attn_params())
        return total + self.vocab * self.d_model * (
            1 if self.tie_embeddings else 2)

    def n_active_params(self) -> int:
        """Params one token reads: every weight but the routed experts it
        is not sent to (``top_k`` of ``n_experts`` per MoE block; the
        router, shared experts, embedding row and head are counted)."""
        if not self.moe:
            return self.n_params()
        total = sum(self._block_params(b, self.moe.top_k if self.moe else 0)
                    for b in self.resolved_pattern)
        return total + self.vocab * self.d_model * (
            1 if self.tie_embeddings else 2)

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
