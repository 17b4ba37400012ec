"""Rank and shape layer between the backend and the kernel wrappers.

The CUDA kernels take flat contiguous tensors and mask ragged edges
themselves, so the reference's pad-to-(8, 128) tiling
(``repro.kernels.dispatch``: ``as_blocked_2d``, ``_gemm_pad_plan``) has no
counterpart here: this layer only makes operands contiguous and checks
GEMM shapes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.s2fp8_matmul import qmatmul_nn
from repro_torch.kernels.s2fp8_quant import quant_apply, truncate_apply

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _kernel_input(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype in _KERNEL_DTYPES else x.float()


def quant_nd(x: torch.Tensor, stats, fmt: str = "e5m2") -> torch.Tensor:
    """Payload of ``x`` in ``x``'s shape, any rank.  A transposed 2-D view
    (the tied LM head's ``embed.T``) is quantized in its storage order and
    the 1-byte payload is transposed, which is the same elementwise map."""
    x = _kernel_input(x)
    if x.is_contiguous():
        return quant_apply(x, stats, fmt)
    if x.dim() == 2 and x.t().is_contiguous():
        p = quant_apply(x.t(), stats, fmt)
        return p.view(torch.uint8).t().contiguous().view(p.dtype)
    return quant_apply(x.contiguous(), stats, fmt)


def truncate_nd(x: torch.Tensor, stats, fmt: str = "e5m2") -> torch.Tensor:
    """Eq. 5 round trip of ``x`` (any rank), in ``x``'s dtype."""
    y = truncate_apply(_kernel_input(x).contiguous(), stats, fmt)
    return y.to(x.dtype)


def qmatmul_nd(a_payload, a_ab, b_payload, b_ab, *, layout: str = "nn",
               epilogue_stats: Optional[torch.Tensor] = None,
               fmt: str = "e5m2") -> torch.Tensor:
    """C[M,N] = deq(A) @ deq(B) for 2-D payloads, any M/K/N."""
    if layout != "nn":
        raise NotImplementedError(
            f"payload GEMM layout {layout!r} comes with the training slice")
    ref.gemm_dims(layout, a_payload.shape, b_payload.shape)

    def contig(p):
        return p if p.is_contiguous() else \
            p.view(torch.uint8).contiguous().view(p.dtype)

    return qmatmul_nn(contig(a_payload), a_ab, contig(b_payload), b_ab,
                      epilogue_stats, fmt)
