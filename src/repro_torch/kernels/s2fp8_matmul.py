"""Payload GEMM (layouts NN, NT, TN, optional fused Eq. 5 epilogue): CUDA
kernels, the planner that picks one for a shape, and plain versions.

``qmatmul_nn``, ``qmatmul_nt`` and ``qmatmul_tn`` replace
``s2fp8_matmul_pallas`` (_matmul_kernel, layouts "nn", "nt", "tn") of
``src/repro/kernels/s2fp8_matmul.py``.  Kernel source:
``repro_torch/csrc/s2fp8_matmul.cu``.

    nn: C[M,N] = deq(A)[M,K]    @ deq(B)[K,N]     forward GEMMs
    nt: C[M,N] = deq(A)[M,K]    @ deq(B)[N,K]^T   dA = g B^T; the tied head
    tn: C[M,N] = deq(A)[K,M]^T  @ deq(B)[K,N]     dB = A^T g

The inverse map is a power law, so the payloads cannot feed fp8 tensor
cores.  :func:`plan_gemm` picks one of two paths from the shape:

* large M (training, prefill, the MoE experts; bound by operations):
  B's tile is dequantized once a stage into shared memory as TF32 (hi,
  lo) pairs, A's into the consumers' registers, and the tensor cores
  (``wgmma``) multiply them in three passes, lo.hi + hi.lo + hi.hi with
  f32 accumulation ("3xTF32"), which keeps the f32 tolerance (one pass
  would not);
* small M (decode, M <= ``SMALL_M`` in NN and NT; bound by the weight's
  bytes): the weight streams once, each code decoded once and used for
  every row with exact f32 FMAs, K split so the grid fills the card, the
  partial sums added in a fixed order by a second kernel.

A layout is only the addressing of the tile loads, the counterpart of the
reference's index-map swaps: no transpose is materialized.  Ragged M/N/K
edges are masked in the kernels; a payload whose rows are not a multiple
of 16 bytes apart (or not 16-byte aligned) is copied here into rows that
are, padded with code 0 (which decodes to 0), so that every tile moves in
16-byte pieces.

``qmatmul_batched`` replaces ``s2fp8_matmul_batched_pallas``
(_batched_matmul_kernel): C[Go,M,N] from A[Ga,.,.] and B[Gb,.,.] in any
layout, over the combined batch G = max(Ga, Gb) where step g reads slice
g % Gx of each operand, with the G / Go groups of steps that share
g % Go summed into one output slice — every expert einsum of the MoE
blocks, forward (NN) and backward (NT for dA, TN for dW, ``out_batch`` for
the dW of a broadcast weight).  The large-M kernel, each output slice's
tiles among its work and a loop over the reduction groups inside each
tile, so every output sums in one fixed order without atomics.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, kernel_entry, plain_version, ref
from repro_torch.kernels.s2fp8_quant import (FMT_ID, PAYLOAD_FMT,
                                             check_cuda_operand, stats_arg)

LAYOUT_ID = {"nn": 0, "nt": 1, "tn": 2}
PATH_ID = {"large": 0, "small": 1}
SMS = 132                # streaming multiprocessors of an H100 SXM
SMALL_M = 16             # most rows of a 2-D NN / NT GEMM on the small path
SMALL_COLS = {"nn": 256, "nt": 128}   # output columns a small-path block
SMALL_KCHUNK_MAX = 2560  # most K a small-path block stages (A's rows)
LARGE_BN = 128           # output columns a large-path block


@dataclass(frozen=True)
class GemmPlan:
    """How one payload GEMM runs: ``path`` "large" (tensor cores, blocks of
    ``bm`` x 128 outputs) or "small" (the decode kernels: K cut into
    ``splits`` pieces of ``kchunk``, a multiple of 16), and its work:
    (column tiles, row tiles or K splits, output slices).  The small path
    launches that grid; the large path's blocks, one a SM, walk the
    tiles."""
    path: str
    bm: int
    splits: int
    kchunk: int
    grid: Tuple[int, int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_gemm(m: int, n: int, k: int, g: Optional[int] = None,
              layout: str = "nn", sms: int = SMS) -> GemmPlan:
    """The path and tiles of C[M,N] over K under ``layout``; ``g`` is the
    output slice count of a batched GEMM, which always takes the large
    path.  A 2-D NN or NT GEMM with M <= SMALL_M takes the small path, K
    split so that the grid covers at least two waves of ``sms`` SMs where
    K allows (pieces of at least 16, at most SMALL_KCHUNK_MAX).  Every
    other GEMM takes the large path, in 64-row blocks for M <= 64 and
    128-row blocks above."""
    if layout not in LAYOUT_ID:
        raise ValueError(f"unknown GEMM layout {layout!r}")
    if g is None and layout in SMALL_COLS and m <= SMALL_M:
        tiles = max(1, _cdiv(n, SMALL_COLS[layout]))
        target = max(1, _cdiv(k, SMALL_KCHUNK_MAX), _cdiv(2 * sms, tiles))
        kchunk = max(16, k // target // 16 * 16)
        splits = max(1, _cdiv(k, kchunk))
        return GemmPlan("small", 8, splits, kchunk, (tiles, splits, 1))
    bm = 64 if m <= 64 else 128
    return GemmPlan("large", bm, 1, k,
                    (_cdiv(n, LARGE_BN), _cdiv(m, bm), 1 if g is None else g))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(p: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``p`` as the kernels read it: rows (the last dimension) a multiple of
    16 bytes apart at a 16-byte aligned address, padded with code 0; a copy
    only where ``p`` is not so already.  Returns (bytes, row stride)."""
    cols = p.shape[-1]
    ld = _cdiv(cols, 16) * 16
    if ld == cols and p.data_ptr() % 16 == 0:
        return p, ld
    out = torch.zeros(p.shape[:-1] + (ld,), dtype=torch.uint8,
                      device=p.device)
    out[..., :cols] = p.view(torch.uint8)
    return out, ld


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


def _launch(layout: str, a, a_ab, b, b_ab, out_ab, fmt, wrapper
            ) -> torch.Tensor:
    check_cuda_operand(a, "a", tuple(PAYLOAD_FMT))
    check_cuda_operand(b, "b", tuple(PAYLOAD_FMT), a.device)
    m, k, n = ref.gemm_dims(layout, a.shape, b.shape)
    aab = stats_arg(a_ab, a.device)
    bab = stats_arg(b_ab, a.device)
    oab = None if out_ab is None else stats_arg(out_ab, a.device)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    plan = plan_gemm(m, n, k, layout=layout, sms=_sms(a.device.index or 0))
    pa, lda = _aligned(a)
    pb, ldb = _aligned(b)
    scratch = (torch.empty((plan.splits, m, n), dtype=torch.float32,
                           device=a.device) if plan.splits > 1 else None)
    rc = build.load("s2fp8_matmul").s2fp8_qmatmul(
        pa.data_ptr(), pb.data_ptr(), out.data_ptr(), build.ptr(scratch), m,
        n, k, lda, ldb, LAYOUT_ID[layout], PATH_ID[plan.path], plan.bm,
        plan.splits, plan.kchunk, aab.data_ptr(), bab.data_ptr(),
        build.ptr(oab), int(oab is not None), FMT_ID[PAYLOAD_FMT[a.dtype]],
        FMT_ID[PAYLOAD_FMT[b.dtype]], FMT_ID[fmt], build.stream_ptr(a.device))
    build.check(rc, f"s2fp8_qmatmul ({layout}, {plan.path})")
    wrapper.launches += 1
    if plan.path == "small":
        wrapper.small_launches += 1
    return out


def _check(layout: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"qmatmul_{layout} wants 2-D payloads, got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    ref.gemm_dims(layout, a.shape, b.shape)


@kernel_entry("qmatmul_nn")
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
    return _launch("nn", a, a_ab, b, b_ab, out_ab, fmt, qmatmul_nn)


@kernel_entry("qmatmul_nt")
def qmatmul_nt(a: torch.Tensor, a_ab, b: torch.Tensor, b_ab,
               out_ab: Optional[torch.Tensor] = None,
               fmt: str = "e5m2") -> torch.Tensor:
    """C[M,N] = deq(a)[M,K] @ deq(b)[N,K]^T, otherwise as ``qmatmul_nn``."""
    _check("nt", a, b)
    if a.device.type == "cpu":
        return qmatmul_nt_plain(a, a_ab, b, b_ab, out_ab, fmt)
    return _launch("nt", a, a_ab, b, b_ab, out_ab, fmt, qmatmul_nt)


@kernel_entry("qmatmul_tn")
def qmatmul_tn(a: torch.Tensor, a_ab, b: torch.Tensor, b_ab,
               out_ab: Optional[torch.Tensor] = None,
               fmt: str = "e5m2") -> torch.Tensor:
    """C[M,N] = deq(a)[K,M]^T @ deq(b)[K,N], otherwise as ``qmatmul_nn``."""
    _check("tn", a, b)
    if a.device.type == "cpu":
        return qmatmul_tn_plain(a, a_ab, b, b_ab, out_ab, fmt)
    return _launch("tn", a, a_ab, b, b_ab, out_ab, fmt, qmatmul_tn)


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


@kernel_entry("qmatmul_batched")
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
    aab = stats_arg(a_ab, a.device)
    bab = stats_arg(b_ab, a.device)
    oab = None if out_ab is None else stats_arg(out_ab, a.device)
    out = torch.empty((go, m, n), dtype=torch.float32, device=a.device)
    plan = plan_gemm(m, n, k, g=go, layout=layout)
    pa, lda = _aligned(a)
    pb, ldb = _aligned(b)
    rc = build.load("s2fp8_matmul").s2fp8_qmatmul_batched(
        pa.data_ptr(), pb.data_ptr(), out.data_ptr(), m, n, k, lda, ldb,
        a.shape[0], b.shape[0], go, g // go, LAYOUT_ID[layout], plan.bm,
        aab.data_ptr(), bab.data_ptr(), build.ptr(oab), int(oab is not None),
        FMT_ID[PAYLOAD_FMT[a.dtype]], FMT_ID[PAYLOAD_FMT[b.dtype]],
        FMT_ID[fmt], build.stream_ptr(a.device))
    build.check(rc, f"s2fp8_qmatmul_batched ({layout})")
    qmatmul_batched.launches += 1
    return out


qmatmul_nn.launches = 0
qmatmul_nt.launches = 0
qmatmul_tn.launches = 0
qmatmul_batched.launches = 0
# launches that took the small (decode) path, a part of ``launches``
qmatmul_nn.small_launches = 0
qmatmul_nt.small_launches = 0
WRAPPERS = {"nn": qmatmul_nn, "nt": qmatmul_nt, "tn": qmatmul_tn}
