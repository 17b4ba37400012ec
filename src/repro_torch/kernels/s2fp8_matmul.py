"""Payload GEMM (NN, optional fused Eq. 5 epilogue): CUDA kernel + plain
version.

``qmatmul_nn`` replaces ``s2fp8_matmul_pallas`` (_matmul_kernel, layout
"nn") of ``src/repro/kernels/s2fp8_matmul.py``.  Kernel source:
``repro_torch/csrc/s2fp8_matmul.cu``.

Bound on the card: f32 operations at prefill widths, the weight payload's
bytes at decode.  The inverse map is a power law, so the payloads cannot
feed fp8 tensor cores: tiles are dequantized through per-block 256-entry
tables into shared memory and multiplied with f32 FMAs (no TF32); ragged
M/N/K edges are masked in the kernel, so nothing is padded here.  The NT
and TN layouts (the backward GEMMs) come with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, plain_version, ref
from repro_torch.kernels.s2fp8_quant import (FMT_ID, check_cuda_operand,
                                             stats_arg)

PAYLOAD_FMT = {torch.float8_e5m2: "e5m2", torch.float8_e4m3fn: "e4m3"}


@plain_version
def qmatmul_plain(a: torch.Tensor, a_ab, b: torch.Tensor, b_ab,
                  out_ab=None, fmt: str = "e5m2") -> torch.Tensor:
    """Plain version: dequantize both payloads, f32 product, optional Eq. 5
    truncation of the output with ``out_ab`` (``ref.s2fp8_matmul_ref``)."""
    return ref.s2fp8_matmul_ref(a, a_ab, b, b_ab, out_ab, layout="nn",
                                fmt=fmt)


def qmatmul_nn(a: torch.Tensor, a_ab, b: torch.Tensor, b_ab,
               out_ab: Optional[torch.Tensor] = None,
               fmt: str = "e5m2") -> torch.Tensor:
    """C[M,N] = deq(a)[M,K] @ deq(b)[K,N] in f32; with ``out_ab`` the output
    is Eq. 5-truncated on the ``fmt`` grid before it is written.  ``a`` and
    ``b`` are 2-D float8 payloads (each operand's format from its dtype)."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"qmatmul_nn wants 2-D payloads, got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    m, k, n = ref.gemm_dims("nn", a.shape, b.shape)
    if a.device.type == "cpu":
        return qmatmul_plain(a, a_ab, b, b_ab, out_ab, fmt)
    check_cuda_operand(a, "a", tuple(PAYLOAD_FMT))
    check_cuda_operand(b, "b", tuple(PAYLOAD_FMT), a.device)
    aab = stats_arg(a_ab, a.device)
    bab = stats_arg(b_ab, a.device)
    oab = None if out_ab is None else stats_arg(out_ab, a.device)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    rc = build.load("s2fp8_matmul").s2fp8_qmatmul_nn(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        aab.data_ptr(), bab.data_ptr(), build.ptr(oab), int(oab is not None),
        FMT_ID[PAYLOAD_FMT[a.dtype]], FMT_ID[PAYLOAD_FMT[b.dtype]],
        FMT_ID[fmt], build.stream_ptr(a.device))
    build.check(rc, "s2fp8_qmatmul_nn")
    qmatmul_nn.launches += 1
    return out


qmatmul_nn.launches = 0
