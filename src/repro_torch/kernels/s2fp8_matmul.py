"""Payload GEMM (layouts NN, NT, TN, optional fused Eq. 5 epilogue): CUDA
kernel + plain versions.

``qmatmul_nn``, ``qmatmul_nt`` and ``qmatmul_tn`` replace
``s2fp8_matmul_pallas`` (_matmul_kernel, layouts "nn", "nt", "tn") of
``src/repro/kernels/s2fp8_matmul.py``.  Kernel source:
``repro_torch/csrc/s2fp8_matmul.cu`` (one kernel templated on the layout).

    nn: C[M,N] = deq(A)[M,K]    @ deq(B)[K,N]     forward GEMMs
    nt: C[M,N] = deq(A)[M,K]    @ deq(B)[N,K]^T   dA = g B^T; the tied head
    tn: C[M,N] = deq(A)[K,M]^T  @ deq(B)[K,N]     dB = A^T g

Bound on the card: f32 operations at training and prefill widths, the
weight payload's bytes at decode.  The inverse map is a power law, so the
payloads cannot feed fp8 tensor cores: tiles are dequantized through
per-block 256-entry tables into shared memory and multiplied with f32 FMAs
(no TF32).  A layout is only the addressing of the tile loads, the
counterpart of the reference's index-map swaps: no transpose is
materialized.  Ragged M/N/K edges are masked in the kernel, so nothing is
padded here.

``qmatmul_batched`` replaces ``s2fp8_matmul_batched_pallas``
(_batched_matmul_kernel): C[Go,M,N] from A[Ga,.,.] and B[Gb,.,.] in any
layout, over the combined batch G = max(Ga, Gb) where step g reads slice
g % Gx of each operand, with the G / Go groups of steps that share
g % Go summed into one output slice — every expert einsum of the MoE
blocks, forward (NN) and backward (NT for dA, TN for dW, ``out_batch`` for
the dW of a broadcast weight).  Same kernel, with a grid axis over the
output slices and a loop over the reduction groups inside each block, so
every output sums in one fixed order without atomics.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, plain_version, ref
from repro_torch.kernels.s2fp8_quant import (FMT_ID, PAYLOAD_FMT,
                                             check_cuda_operand, stats_arg)

LAYOUT_ID = {"nn": 0, "nt": 1, "tn": 2}


def _plain(layout: str):
    def fn(a: torch.Tensor, a_ab, b: torch.Tensor, b_ab, out_ab=None,
           fmt: str = "e5m2") -> torch.Tensor:
        return ref.s2fp8_matmul_ref(a, a_ab, b, b_ab, out_ab, layout=layout,
                                    fmt=fmt)
    fn.__name__ = fn.__qualname__ = ("qmatmul_plain" if layout == "nn"
                                     else f"qmatmul_{layout}_plain")
    fn.__doc__ = (f"Plain version, layout {layout!r}: dequantize both "
                  f"payloads, f32 product, optional Eq. 5 truncation of the "
                  f"output with ``out_ab`` (``ref.s2fp8_matmul_ref``).")
    return plain_version(fn)


qmatmul_plain = _plain("nn")
qmatmul_nt_plain = _plain("nt")
qmatmul_tn_plain = _plain("tn")


def _launch(layout: str, a, a_ab, b, b_ab, out_ab, fmt) -> torch.Tensor:
    check_cuda_operand(a, "a", tuple(PAYLOAD_FMT))
    check_cuda_operand(b, "b", tuple(PAYLOAD_FMT), a.device)
    m, k, n = ref.gemm_dims(layout, a.shape, b.shape)
    aab = stats_arg(a_ab, a.device)
    bab = stats_arg(b_ab, a.device)
    oab = None if out_ab is None else stats_arg(out_ab, a.device)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    rc = build.load("s2fp8_matmul").s2fp8_qmatmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        LAYOUT_ID[layout], aab.data_ptr(), bab.data_ptr(), build.ptr(oab),
        int(oab is not None), FMT_ID[PAYLOAD_FMT[a.dtype]],
        FMT_ID[PAYLOAD_FMT[b.dtype]], FMT_ID[fmt], build.stream_ptr(a.device))
    build.check(rc, f"s2fp8_qmatmul ({layout})")
    return out


def _check(layout: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"qmatmul_{layout} wants 2-D payloads, got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    ref.gemm_dims(layout, a.shape, b.shape)


def qmatmul_nn(a: torch.Tensor, a_ab, b: torch.Tensor, b_ab,
               out_ab: Optional[torch.Tensor] = None,
               fmt: str = "e5m2") -> torch.Tensor:
    """C[M,N] = deq(a)[M,K] @ deq(b)[K,N] in f32; with ``out_ab`` the output
    is Eq. 5-truncated on the ``fmt`` grid before it is written.  ``a`` and
    ``b`` are 2-D float8 payloads (each operand's format from its dtype).
    CPU tensors take the plain version."""
    _check("nn", a, b)
    if a.device.type == "cpu":
        return qmatmul_plain(a, a_ab, b, b_ab, out_ab, fmt)
    out = _launch("nn", a, a_ab, b, b_ab, out_ab, fmt)
    qmatmul_nn.launches += 1
    return out


def qmatmul_nt(a: torch.Tensor, a_ab, b: torch.Tensor, b_ab,
               out_ab: Optional[torch.Tensor] = None,
               fmt: str = "e5m2") -> torch.Tensor:
    """C[M,N] = deq(a)[M,K] @ deq(b)[N,K]^T, otherwise as ``qmatmul_nn``."""
    _check("nt", a, b)
    if a.device.type == "cpu":
        return qmatmul_nt_plain(a, a_ab, b, b_ab, out_ab, fmt)
    out = _launch("nt", a, a_ab, b, b_ab, out_ab, fmt)
    qmatmul_nt.launches += 1
    return out


def qmatmul_tn(a: torch.Tensor, a_ab, b: torch.Tensor, b_ab,
               out_ab: Optional[torch.Tensor] = None,
               fmt: str = "e5m2") -> torch.Tensor:
    """C[M,N] = deq(a)[K,M]^T @ deq(b)[K,N], otherwise as ``qmatmul_nn``."""
    _check("tn", a, b)
    if a.device.type == "cpu":
        return qmatmul_tn_plain(a, a_ab, b, b_ab, out_ab, fmt)
    out = _launch("tn", a, a_ab, b, b_ab, out_ab, fmt)
    qmatmul_tn.launches += 1
    return out


@plain_version
def qmatmul_batched_plain(a: torch.Tensor, a_ab, b: torch.Tensor, b_ab,
                          out_ab=None, *, layout: str = "nn",
                          out_batch: Optional[int] = None,
                          fmt: str = "e5m2") -> torch.Tensor:
    """Plain version of the batched GEMM: dequantize, expand both operands
    to the combined batch, one f32 einsum, the group sum, then the optional
    Eq. 5 truncation (``ref.s2fp8_matmul_batched_ref``)."""
    return ref.s2fp8_matmul_batched_ref(a, a_ab, b, b_ab, out_ab,
                                        layout=layout, out_batch=out_batch,
                                        fmt=fmt)


def qmatmul_batched(a: torch.Tensor, a_ab, b: torch.Tensor, b_ab,
                    out_ab: Optional[torch.Tensor] = None, *,
                    layout: str = "nn", out_batch: Optional[int] = None,
                    fmt: str = "e5m2") -> torch.Tensor:
    """C[Go,M,N] (f32) of 3-D float8 payloads ``a`` [Ga, ., .] and ``b``
    [Gb, ., .] under ``layout`` (per slice, as ``qmatmul_nn`` and
    friends); ``out_batch`` (default G) sums the broadcast groups; with
    ``out_ab`` the summed output is Eq. 5-truncated on the ``fmt`` grid.
    CPU tensors take the plain version."""
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"qmatmul_batched wants 3-D payloads, got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    g, go = ref.batched_dims(a.shape[0], b.shape[0], out_batch)
    m, k, n = ref.gemm_dims(layout, a.shape[1:], b.shape[1:])
    if a.device.type == "cpu":
        return qmatmul_batched_plain(a, a_ab, b, b_ab, out_ab, layout=layout,
                                     out_batch=out_batch, fmt=fmt)
    check_cuda_operand(a, "a", tuple(PAYLOAD_FMT))
    check_cuda_operand(b, "b", tuple(PAYLOAD_FMT), a.device)
    if go > 65535:
        raise ValueError(f"out_batch {go} exceeds the grid's z limit 65535")
    aab = stats_arg(a_ab, a.device)
    bab = stats_arg(b_ab, a.device)
    oab = None if out_ab is None else stats_arg(out_ab, a.device)
    out = torch.empty((go, m, n), dtype=torch.float32, device=a.device)
    rc = build.load("s2fp8_matmul").s2fp8_qmatmul_batched(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, a.shape[0],
        b.shape[0], go, g // go, LAYOUT_ID[layout], aab.data_ptr(),
        bab.data_ptr(), build.ptr(oab), int(oab is not None),
        FMT_ID[PAYLOAD_FMT[a.dtype]], FMT_ID[PAYLOAD_FMT[b.dtype]],
        FMT_ID[fmt], build.stream_ptr(a.device))
    build.check(rc, f"s2fp8_qmatmul_batched ({layout})")
    qmatmul_batched.launches += 1
    return out


qmatmul_nn.launches = 0
qmatmul_nt.launches = 0
qmatmul_tn.launches = 0
qmatmul_batched.launches = 0
WRAPPERS = {"nn": qmatmul_nn, "nt": qmatmul_nt, "tn": qmatmul_tn}
