"""Plain PyTorch oracles (port of ``repro.kernels.ref``): the semantic
ground truth each kernel's plain version is built from."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import s2fp8

GEMM_LAYOUTS = ("nn", "nt", "tn")
# Operand layouts as einsum contractions (the reference's dot_general
# dimension numbers):
#   "nn": C[M,N] = A[M,K]  @ B[K,N]
#   "nt": C[M,N] = A[M,K]  @ B[N,K]^T
#   "tn": C[M,N] = A[K,M]^T @ B[K,N]
GEMM_CONTRACT = {"nn": "mk,kn->mn", "nt": "mk,nk->mn", "tn": "km,kn->mn"}


def gemm_dims(layout: str, a_shape, b_shape):
    """(m, k, n) of the logical GEMM for stored operand shapes."""
    if layout == "nn":
        (m, k), (k2, n) = a_shape, b_shape
    elif layout == "nt":
        (m, k), (n, k2) = a_shape, b_shape
    elif layout == "tn":
        (k, m), (k2, n) = a_shape, b_shape
    else:
        raise ValueError(f"unknown GEMM layout {layout!r}; want {GEMM_LAYOUTS}")
    if k != k2:
        raise ValueError(f"contraction mismatch: {tuple(a_shape)} x "
                         f"{tuple(b_shape)} under layout {layout!r}")
    return m, k, n


def s2fp8_dequant_ref(payload, ab, dtype=torch.float32):
    return s2fp8.dequantize(s2fp8.S2FP8Tensor(payload, s2fp8.as_stats(
        ab, payload.device)), dtype)


def s2fp8_truncate_ref(x, stats=None, fmt: str = "e5m2"):
    """Eq. 5 round-trip oracle (any rank), in ``x``'s dtype."""
    if fmt == "e4m3":
        return s2fp8.truncate_value_e4m3(x, stats=stats)
    return s2fp8.truncate_value(x, stats=stats)


def s2fp8_matmul_ref(a_payload, a_ab, b_payload, b_ab,
                     out_ab: Optional[torch.Tensor] = None, *,
                     layout: str = "nn", fmt: str = "e5m2"):
    """Dequant-GEMM oracle in f32, optionally Eq. 5-truncated with the
    output site's stats ``out_ab``."""
    a = s2fp8_dequant_ref(a_payload, a_ab)
    b = s2fp8_dequant_ref(b_payload, b_ab)
    y = torch.einsum(GEMM_CONTRACT[layout], a, b)
    if out_ab is not None:
        y = s2fp8_truncate_ref(y, stats=out_ab, fmt=fmt)
    return y
