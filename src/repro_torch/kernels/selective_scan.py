"""Mamba-1 selective scan: CUDA kernel + plain version.

``selective_scan`` replaces ``selective_scan_pallas`` (_scan_kernel) of
``src/repro/kernels/selective_scan.py``.  Kernel source:
``repro_torch/csrc/selective_scan.cu``.

Function (the TPU kernel's): x, dt [B, S, di]; B, C [B, S, n]; A [di, n];
D [di], all f32.  Per step ``h = h * exp(dt A) + (dt x) B`` and ``y = h.C
+ D x``; returns (y [B, S, di], the final h [B, di, n]).

Bound on the card: bytes (x, dt and y stream once; the state stays on
chip).  Design: a
channel's n <= 16 states split over 4 lanes of a warp (4 states each in
registers, the lanes' shares of h.C summed by a fixed shuffle tree),
blocks of 64 channels of one row, chunks of 16 timesteps staged in shared
memory with cp.async, double-buffered, y gathered there and stored as
16-byte vectors along di.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, plain_version, ref
from repro_torch.kernels.s2fp8_quant import check_cuda_operand

MAX_STATE = 16


def _check_shapes(x, dt, bmat, cmat, a, d_skip) -> None:
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"selective_scan wants x, dt [B, S, di]; got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}")
    b, s, di = x.shape
    n = bmat.shape[-1]
    if bmat.shape != (b, s, n) or cmat.shape != (b, s, n):
        raise ValueError(f"selective_scan wants B, C [{b}, {s}, n]; got "
                         f"{tuple(bmat.shape)}, {tuple(cmat.shape)}")
    if a.shape != (di, n) or d_skip.shape != (di,):
        raise ValueError(f"selective_scan wants A [{di}, {n}] and D [{di}]; "
                         f"got {tuple(a.shape)}, {tuple(d_skip.shape)}")


@plain_version
def selective_scan_plain(x, dt, bmat, cmat, a, d_skip
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``ref.selective_scan_ref``, the kernel's recurrence
    step by step in f32, each multiply and add rounded alone as the kernel
    rounds them (only the sum over n may run in another order)."""
    _check_shapes(x, dt, bmat, cmat, a, d_skip)
    return ref.selective_scan_ref(x, dt, bmat, cmat, a, d_skip)


def selective_scan(x, dt, bmat, cmat, a, d_skip
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y f32 [B, S, di], h f32 [B, di, n]) of the selective scan; every
    input f32 and contiguous on one CUDA device, n <= 16.  CPU tensors take
    the plain version."""
    _check_shapes(x, dt, bmat, cmat, a, d_skip)
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, bmat, cmat, a, d_skip)
    for name, t in (("x", x), ("dt", dt), ("B", bmat), ("C", cmat),
                    ("A", a), ("D", d_skip)):
        check_cuda_operand(t, name, (torch.float32,), x.device)
    b, s, di = x.shape
    n = bmat.shape[-1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan kernel takes 1..{MAX_STATE} "
                         f"states, got {n}")
    y = torch.empty_like(x)
    h = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    rc = build.load("selective_scan").selective_scan(
        x.data_ptr(), dt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        a.data_ptr(), d_skip.data_ptr(), y.data_ptr(), h.data_ptr(), b, s,
        di, n, build.stream_ptr(x.device))
    build.check(rc, "selective_scan")
    selective_scan.launches += 1
    return y, h


selective_scan.launches = 0
