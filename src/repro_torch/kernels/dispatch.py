"""Rank and shape layer between the backend and the kernel wrappers.

The CUDA kernels take flat contiguous tensors and mask ragged edges
themselves, so the reference's pad-to-(8, 128) tiling
(``repro.kernels.dispatch``: ``as_blocked_2d``, ``_gemm_pad_plan``,
``pad_to_lane``) has no counterpart here: this layer makes operands
contiguous, checks GEMM shapes, picks the GEMM layout's wrapper, and maps
the grouped attention layout ``[B, KV, G, S, d]`` onto the kernels'
flattened ``[B*KV*G, S, d]`` heads and back.

Stats selection of the quantize and truncate entry points follows the
reference's (``stats_nd``, ``quant_nd(stats=None)``,
``truncate_nd(fused_stats=...)``): given (alpha, beta), one elementwise
pass; without them, exact stats of the tensor — the torch reduction
(``s2fp8.compute_stats``), or with ``fused_stats`` the stats kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import s2fp8
from repro_torch.core.s2fp8 import S2FP8Tensor
from repro_torch.kernels import flash_attention as fkern
from repro_torch.kernels import ref
from repro_torch.kernels.s2fp8_matmul import WRAPPERS, qmatmul_batched
from repro_torch.kernels.s2fp8_quant import (dequant, quant, quant_apply,
                                             stats_partials, truncate_apply,
                                             truncate_fused)

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _kernel_input(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype in _KERNEL_DTYPES else x.float()


def _contig_payload(p: torch.Tensor) -> torch.Tensor:
    return p if p.is_contiguous() else \
        p.view(torch.uint8).contiguous().view(p.dtype)


def stats_partials_nd(x: torch.Tensor):
    """(sum log2|x|, max log2|x|, nonzero count) of ``x`` (any rank) from
    the stats kernel, three f32 scalars on x's device."""
    triplet, _ = stats_partials(_kernel_input(x).contiguous())
    return triplet[0], triplet[1], triplet[2]


def stats_nd(x: torch.Tensor, target_max: float = s2fp8.TARGET_MAX_LOG2
             ) -> torch.Tensor:
    """(alpha, beta) of ``x`` (any rank) from the stats kernel, f32 [2]."""
    return stats_partials(_kernel_input(x).contiguous(), target_max)[1]


def quant_nd(x: torch.Tensor, stats=None, fmt: str = "e5m2"):
    """(payload in ``x``'s shape, ab), any rank: with ``stats``, the
    quantize-apply kernel; without, the quantize-with-stats kernel."""
    x = _kernel_input(x).contiguous()
    if stats is None:
        return quant(x, fmt)
    ab = s2fp8.as_stats(stats, x.device)
    return quant_apply(x, ab, fmt), ab


def dequant_nd(payload: torch.Tensor, stats, dtype=torch.float32
               ) -> torch.Tensor:
    """Eq. 4 values of a payload of any rank, in ``dtype``."""
    return dequant(_contig_payload(payload), stats).to(dtype)


def truncate_nd(x: torch.Tensor, stats=None, fmt: str = "e5m2",
                fused_stats: bool = False) -> torch.Tensor:
    """Eq. 5 round trip of ``x`` (any rank), in ``x``'s dtype.  Without
    ``stats``: exact stats of ``x``, in the fused kernel with
    ``fused_stats``, else from the torch reduction."""
    xk = _kernel_input(x).contiguous()
    if stats is None and fused_stats:
        y, _ = truncate_fused(xk, fmt)
    else:
        if stats is None:
            stats = s2fp8.compute_stats(x, s2fp8.FMT_TARGET_MAX[fmt])
        y = truncate_apply(xk, stats, fmt)
    return y.to(x.dtype)


def qmatmul_nd(a_payload, a_ab, b_payload, b_ab, *, layout: str = "nn",
               epilogue_stats: Optional[torch.Tensor] = None,
               fmt: str = "e5m2") -> torch.Tensor:
    """The layout's payload GEMM for 2-D payloads, any M/K/N
    (``ref.GEMM_CONTRACT`` names the three layouts)."""
    ref.gemm_dims(layout, a_payload.shape, b_payload.shape)
    return WRAPPERS[layout](_contig_payload(a_payload), a_ab,
                            _contig_payload(b_payload), b_ab,
                            epilogue_stats, fmt)


def qmatmul_batched_nd(a_payload, a_ab, b_payload, b_ab, *,
                       layout: str = "nn", out_batch: Optional[int] = None,
                       epilogue_stats: Optional[torch.Tensor] = None,
                       fmt: str = "e5m2") -> torch.Tensor:
    """The batched payload GEMM for 3-D payloads, any M/K/N: C[Go,M,N] with
    the broadcast and ``out_batch`` semantics of ``qmatmul_batched``.  The
    kernel masks ragged edges, so nothing is padded (the reference pads
    for Pallas tiles only)."""
    return qmatmul_batched(_contig_payload(a_payload), a_ab,
                           _contig_payload(b_payload), b_ab, epilogue_stats,
                           layout=layout, out_batch=out_batch, fmt=fmt)


def _heads(t: S2FP8Tensor) -> torch.Tensor:
    """[B, KV, G, S, d] or [B, KV, S, d] payload -> [B*KV(*G), S, d]."""
    p = _contig_payload(t.payload)
    return p.reshape(-1, p.shape[-2], p.shape[-1])


def qflash_fwd_grouped(qq: S2FP8Tensor, qk: S2FP8Tensor, qv: S2FP8Tensor, *,
                       causal: bool, window, scale: float, out_ab, fmt: str):
    """Payload flash forward in the grouped layout: q [B,KV,G,Sq,d], k/v
    [B,KV,Sk,d] -> (out f32 [B,KV,G,Sq,d], lse [B,KV,G,Sq,1])."""
    b, kvh, g, sq, d = qq.payload.shape
    out, lse = fkern.qflash_fwd(_heads(qq), _heads(qk), _heads(qv), qq.ab,
                                qk.ab, qv.ab, g=g, causal=causal,
                                window=window, scale=scale, out_ab=out_ab,
                                fmt=fmt)
    return out.reshape(b, kvh, g, sq, d), lse.reshape(b, kvh, g, sq, 1)


def qflash_bwd_grouped(qq: S2FP8Tensor, qk: S2FP8Tensor, qv: S2FP8Tensor,
                       qg: S2FP8Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, *, causal: bool, window,
                       scale: float):
    """Payload flash backward in the grouped layout -> raw f32 (dq
    [B,KV,G,Sq,d], dk, dv [B,KV,Sk,d]).  The kernels write per-head dk/dv;
    their sum over the G query heads of each K/V head happens here."""
    b, kvh, g, sq, d = qq.payload.shape
    sk = qk.payload.shape[2]
    dq, dkh, dvh = fkern.qflash_bwd(
        _heads(qq), _heads(qk), _heads(qv), _heads(qg), qq.ab, qk.ab, qv.ab,
        qg.ab, lse.reshape(b * kvh * g, sq).contiguous(),
        delta.reshape(b * kvh * g, sq).contiguous(), g=g, causal=causal,
        window=window, scale=scale)
    return (dq.reshape(b, kvh, g, sq, d),
            dkh.reshape(b, kvh, g, sk, d).sum(dim=2),
            dvh.reshape(b, kvh, g, sk, d).sum(dim=2))
