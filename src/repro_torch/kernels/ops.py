"""Public kernel API (port of ``repro.kernels.ops``): each function picks
the CUDA kernel or the plain oracle of ``kernels/ref.py``.

``use_kernel=None`` (default) launches the kernel for a CUDA tensor and
takes the oracle for a CPU tensor; ``use_kernel=True`` on a CPU tensor
raises (the kernels run only on the card); ``use_kernel=False`` takes the
oracle on either device.  Shapes of any rank go through
``kernels/dispatch.py``.

One difference stays as the reference has it: for a query row that sees
no key (a window or causal mask that hides every key), the kernel of
``flash_attention`` gives 0 and the oracle ``ref.attention_ref`` NaN
(its -inf fill).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import flash_attention as fkern


def _use_kernel(flag: Optional[bool], *tensors: torch.Tensor) -> bool:
    on_card = all(t.device.type == "cuda" for t in tensors)
    if flag is None:
        return on_card
    if flag and not on_card:
        raise ValueError("use_kernel=True needs CUDA tensors; the kernels "
                         "run only on the card")
    return flag


def s2fp8_quant(x: torch.Tensor, *, use_kernel: Optional[bool] = None):
    """(payload_e5m2, alpha, beta) of ``x`` with its own exact stats; any
    rank."""
    if _use_kernel(use_kernel, x):
        payload, ab = dispatch.quant_nd(x)
        return payload, ab[0], ab[1]
    return ref.s2fp8_quant_ref(x)


def s2fp8_dequant(payload, alpha, beta, *,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """f32 values of an S2FP8 payload of any rank."""
    if _use_kernel(use_kernel, payload):
        return dispatch.dequant_nd(payload, (alpha, beta))
    return ref.s2fp8_dequant_ref(payload, (alpha, beta))


def s2fp8_truncate(x: torch.Tensor, *, stats=None, fmt: str = "e5m2",
                   use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Eq. 5 round trip of ``x`` in its dtype; ``stats=(alpha, beta)``
    skips the reduction (the delayed-stats path), otherwise the exact stats
    of ``x`` come from the torch reduction, as in the reference."""
    if _use_kernel(use_kernel, x):
        return dispatch.truncate_nd(x, stats=stats, fmt=fmt)
    return ref.s2fp8_truncate_ref(x, stats=stats, fmt=fmt)


def s2fp8_matmul(a_payload, a_alpha, a_beta, b_payload, b_alpha, b_beta, *,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """f32 dequant(A) @ dequant(B) of 2-D payloads, f32 accumulation."""
    if _use_kernel(use_kernel, a_payload, b_payload):
        return dispatch.qmatmul_nd(a_payload, (a_alpha, a_beta), b_payload,
                                   (b_alpha, b_beta))
    return ref.s2fp8_matmul_ref(a_payload, (a_alpha, a_beta), b_payload,
                                (b_alpha, b_beta))


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Softmax attention, q [B,H,Sq,D], k/v [B,H,Sk,D] (KV heads already
    broadcast), query rows aligned to the end of the key axis.  The kernel
    returns q's dtype (f32 or bf16, accumulated in f32); the oracle f32."""
    if _use_kernel(use_kernel, q, k, v):
        return fkern.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=causal,
                                     window=window)
    return ref.attention_ref(q, k, v, causal=causal, window=window)
