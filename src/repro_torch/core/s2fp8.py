"""S2FP8 — Shifted & Squeezed FP8 (Cambier et al., ICLR 2020), Eq. 1–5.

Port of ``repro.core.s2fp8``: a tensor ``X`` is an 8-bit payload ``Y``
plus f32 statistics (alpha, beta) with ``log2|Y| = alpha*log2|X| + beta``
(sign kept, zeros kept), alpha = target / (max - mean) and beta =
-alpha * mean over the nonzero elements of log2|X|.

(alpha, beta) travel as ONE f32 tensor of shape [2] (``ab``), on the
device of the data: the CUDA kernels read them through a pointer, so
quantizing with device-resident stats never waits on the host.

``dequantize(quantize(x, s)) == truncate_value(x, s)`` elementwise, bit for
bit — the identity the payload GEMMs and the paged KV cache rely on.

The differentiable truncations (``truncate_ste``, ``truncate_bidir``,
``fp8_truncate_bidir``) are ``torch.autograd.Function``s with the
reference's gradient rules.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import fp8

TARGET_MAX_LOG2 = 15.0
TARGET_MAX_LOG2_E4M3 = 8.0
# Guard for constant-magnitude tensors (max == mean of log2|X|): pure shift.
_DEGENERATE_EPS = 1e-6

FMT_TARGET_MAX = {"e5m2": TARGET_MAX_LOG2, "e4m3": TARGET_MAX_LOG2_E4M3}
FMT_QDTYPE = {"e5m2": torch.float8_e5m2, "e4m3": torch.float8_e4m3fn}
FMT_MAX_FINITE = {"e5m2": fp8.E5M2_MAX, "e4m3": fp8.E4M3_MAX}

StatsLike = Union[torch.Tensor, Tuple]


def as_stats(stats: StatsLike, device=None) -> torch.Tensor:
    """(alpha, beta) as a contiguous f32 [2] tensor (``ab``)."""
    if isinstance(stats, torch.Tensor):
        ab = stats.to(device=device or stats.device, dtype=torch.float32)
        if ab.numel() != 2:
            raise ValueError(f"stats tensor must hold (alpha, beta); got "
                             f"shape {tuple(stats.shape)}")
        return ab.reshape(2).contiguous()
    alpha, beta = stats
    parts = [torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())
             for v in (alpha, beta)]
    return torch.stack(parts)


@dataclasses.dataclass(frozen=True)
class S2FP8Tensor:
    """Storage representation: 8-bit payload + (alpha, beta) as ``ab``."""

    payload: torch.Tensor      # float8 (per ``fmt``), same shape as source
    ab: torch.Tensor           # f32 [2]: (alpha, beta)
    fmt: str = "e5m2"

    @property
    def alpha(self) -> torch.Tensor:
        return self.ab[0]

    @property
    def beta(self) -> torch.Tensor:
        return self.ab[1]

    @property
    def shape(self):
        return self.payload.shape

    def reshape(self, *shape) -> "S2FP8Tensor":
        """Payload reshape (1-byte move); stats are global, so they carry."""
        return S2FP8Tensor(self.payload.reshape(*shape), self.ab, self.fmt)


def stats_from_reduction(log_sum, log_max, count,
                         target_max: float = TARGET_MAX_LOG2
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum log2|X|, max log2|X|, nonzero count) -> (alpha, beta), Eq. 3–4,
    with the reference's degenerate-case conventions:

      * all-zero tensor      -> identity transform (alpha=1, beta=0)
      * constant |X| (m==mu) -> pure shift pinning the max at 2^target_max
    """
    mu = log_sum / torch.clamp(count, min=1.0)
    spread = log_max - mu
    degenerate = spread < _DEGENERATE_EPS
    alpha = torch.where(degenerate, 1.0,
                        target_max / torch.where(degenerate, 1.0, spread))
    beta = torch.where(degenerate, target_max - log_max, -alpha * mu)
    empty = count == 0
    alpha = torch.where(empty, 1.0, alpha)
    beta = torch.where(empty, 0.0, beta)
    return alpha.float(), beta.float()


def compute_stats_partials(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw reduction triplet (sum log2|X|, max log2|X|, nonzero count as f32)
    over the nonzero elements; ``log_max`` is -inf for an all-zero tensor."""
    absx = x.abs().float()
    # NaN > 0 is false: NaNs are left out like zeros, as in the reference.
    nonzero = absx > 0.0
    count = nonzero.sum().float()
    # Two temporaries the size of x, at any size: the excluded elements
    # are -inf for the max (all excluded -> -inf, as wanted), 0 for the sum.
    logx = torch.log2(absx).masked_fill_(~nonzero, -math.inf)
    log_max = logx.max()
    log_sum = logx.masked_fill_(~nonzero, 0.0).sum()
    return log_sum, log_max, count


def compute_stats(x: torch.Tensor, target_max: float = TARGET_MAX_LOG2
                  ) -> torch.Tensor:
    """(alpha, beta) of ``x`` per Eq. 3–4 as an f32 [2] tensor."""
    alpha, beta = stats_from_reduction(*compute_stats_partials(x), target_max)
    return torch.stack([alpha, beta])


def _forward_map(x: torch.Tensor, alpha, beta) -> torch.Tensor:
    """Y = sign(X) * 2^{alpha*log2|X| + beta}, zeros preserved (f32).
    The multiply and the add round separately, as the kernels do."""
    absx = x.abs()
    nonzero = absx > 0.0
    ylog = alpha * torch.log2(torch.where(nonzero, absx, 1.0)) + beta
    y = torch.sign(x) * torch.exp2(ylog)
    return torch.where(nonzero, y, 0.0).float()


def _inverse_map(y: torch.Tensor, alpha, beta) -> torch.Tensor:
    """X = sign(Y) * 2^{(log2|Y| - beta)/alpha}, zeros preserved (f32)."""
    y = y.float()
    absy = y.abs()
    nonzero = absy > 0.0
    xlog = (torch.log2(torch.where(nonzero, absy, 1.0)) - beta) / alpha
    x = torch.sign(y) * torch.exp2(xlog)
    return torch.where(nonzero, x, 0.0)


def quantize(x: torch.Tensor, stats: Optional[StatsLike] = None,
             fmt: str = "e5m2") -> S2FP8Tensor:
    """Float tensor -> S2FP8 storage.  The forward image is clamped at the
    format's max finite before the RNE cast, so stale stats saturate."""
    ab = (compute_stats(x, FMT_TARGET_MAX[fmt]) if stats is None
          else as_stats(stats, x.device))
    y = _forward_map(x.float(), ab[0], ab[1])
    fmax = FMT_MAX_FINITE[fmt]
    y = torch.clamp(y, -fmax, fmax)
    return S2FP8Tensor(y.to(FMT_QDTYPE[fmt]), ab, fmt)


def dequantize(t: S2FP8Tensor, dtype=torch.float32) -> torch.Tensor:
    """S2FP8 storage -> dense tensor."""
    return _inverse_map(t.payload.float(), t.ab[0], t.ab[1]).to(dtype)


def _truncate(x, stats, fmt: str) -> torch.Tensor:
    ab = (compute_stats(x, FMT_TARGET_MAX[fmt]) if stats is None
          else as_stats(stats, x.device))
    y = _forward_map(x.float(), ab[0], ab[1])
    fmax = FMT_MAX_FINITE[fmt]
    yq = torch.clamp(y, -fmax, fmax).to(FMT_QDTYPE[fmt]).float()
    return _inverse_map(yq, ab[0], ab[1]).to(x.dtype)


def truncate_value(x: torch.Tensor, stats: Optional[StatsLike] = None
                   ) -> torch.Tensor:
    """Paper Eq. 5, e5m2: the value semantics of the S2FP8 round trip,
    returned in ``x``'s dtype."""
    return _truncate(x, stats, "e5m2")


def truncate_value_e4m3(x: torch.Tensor, stats: Optional[StatsLike] = None
                        ) -> torch.Tensor:
    """Eq. 5 round trip on the e4m3 grid (range pinned at 2^8)."""
    return _truncate(x, stats, "e4m3")


# ---------------------------------------------------------------------------
# Differentiable truncations (reference s2fp8.py:275-330).
#
# ``truncate_ste``       : T on the forward value, identity on the cotangent.
# ``truncate_bidir``     : T on the forward value AND on the cotangent.
# ``fp8_truncate_bidir`` : raw e5m2 RNE both ways (the paper's baseline;
#                          unclamped, so it overflows to inf).
# Each truncation computes exact per-call stats of the tensor it rounds.
# ---------------------------------------------------------------------------

class _TruncateSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return truncate_value(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _TruncateBidir(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return truncate_value(x)

    @staticmethod
    def backward(ctx, g):
        return truncate_value(g)


class _FP8TruncateBidir(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return fp8.truncate_e5m2(x)

    @staticmethod
    def backward(ctx, g):
        return fp8.truncate_e5m2(g)


def truncate_ste(x: torch.Tensor) -> torch.Tensor:
    return _TruncateSTE.apply(x)


def truncate_bidir(x: torch.Tensor) -> torch.Tensor:
    return _TruncateBidir.apply(x)


def fp8_truncate_bidir(x: torch.Tensor) -> torch.Tensor:
    return _FP8TruncateBidir.apply(x)


def tensor_stats(x: torch.Tensor) -> dict:
    """(mu, m, alpha, beta) of ``x`` for logging (paper Fig. 5)."""
    log_sum, log_max, count = compute_stats_partials(x)
    alpha, beta = stats_from_reduction(log_sum, log_max, count)
    return {"mu": log_sum / torch.clamp(count, min=1.0), "m": log_max,
            "alpha": alpha, "beta": beta}
