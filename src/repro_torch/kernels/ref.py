"""Plain PyTorch oracles (port of ``repro.kernels.ref``): the semantic
ground truth each kernel's plain version is built from."""
from __future__ import annotations

import math
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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits) as the flash kernels
    round it: toward zero, the low 13 bits cleared; kept in f32."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


def split_tf32(x: torch.Tensor):
    """The flash kernels' compensated split: (hi, lo) = (tf32(x), tf32(x -
    hi)), both TF32, hi + lo = x to within 2^-21 |x|.  A product is then
    taken as lo_a hi_b + hi_a lo_b + hi_a hi_b ("3xTF32")."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def s2fp8_stats_partials_ref(x: torch.Tensor) -> torch.Tensor:
    """Stats reduction oracle: f32 [3] of (sum log2|X|, max log2|X|,
    nonzero count) over the nonzero elements (zeros and NaNs left out),
    the sum taken in f64 and rounded once to f32, the count exact before
    its cast: the reduction the stats kernels compute, in another order.
    ``max`` is -inf for an all-zero (or empty) tensor."""
    absx = x.detach().abs().float()
    nonzero = absx > 0.0
    logx = torch.log2(absx)
    log_max = (logx.masked_fill(~nonzero, -math.inf).max() if x.numel()
               else torch.tensor(-math.inf, device=x.device))
    log_sum = logx.masked_fill_(~nonzero, 0.0).double().sum()
    return torch.stack([log_sum.float(), log_max,
                        nonzero.sum().float()])


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


def batched_dims(ga: int, gb: int, out_batch: Optional[int] = None):
    """(G, Go) of a batched payload GEMM with operand batches ``ga`` and
    ``gb``: the combined batch ``G = max(Ga, Gb)`` (each must divide it)
    and the output batch ``Go`` (default ``G``; it must divide ``G``)."""
    g = max(ga, gb)
    if min(ga, gb) < 1 or g % ga or g % gb:
        raise ValueError(f"batch sizes {ga} / {gb} do not divide evenly")
    go = g if out_batch is None else int(out_batch)
    if go < 1 or g % go:
        raise ValueError(f"out_batch {go} does not divide batch {g}")
    return g, go


def s2fp8_matmul_batched_ref(a_payload, a_ab, b_payload, b_ab,
                             out_ab: Optional[torch.Tensor] = None, *,
                             layout: str = "nn",
                             out_batch: Optional[int] = None,
                             fmt: str = "e5m2"):
    """Batched dequant-GEMM oracle: ``a [Ga, ., .] x b [Gb, ., .]`` over the
    combined batch ``G = max(Ga, Gb)``, where operand slice ``g % Gx``
    feeds combined step ``g`` (the trailing-aligned broadcast);
    ``out_batch < G`` sums the ``G // out_batch`` groups of steps that share
    ``g % out_batch`` into one output slice.  Per-slice layouts as
    :func:`s2fp8_matmul_ref`; the optional Eq. 5 epilogue runs on the
    summed output."""
    g, go = batched_dims(a_payload.shape[0], b_payload.shape[0], out_batch)
    gemm_dims(layout, a_payload.shape[1:], b_payload.shape[1:])
    a = s2fp8_dequant_ref(a_payload, a_ab)
    b = s2fp8_dequant_ref(b_payload, b_ab)
    # repeat tiles the whole batch, so slice i of the result is x[i % Gx]
    a = a.repeat(g // a.shape[0], 1, 1)
    b = b.repeat(g // b.shape[0], 1, 1)
    y = torch.einsum("g" + GEMM_CONTRACT[layout].replace(",", ",g")
                     .replace("->", "->g"), a, b)
    if go != g:
        y = y.reshape((g // go, go) + tuple(y.shape[1:])).sum(dim=0)
    if out_ab is not None:
        y = s2fp8_truncate_ref(y, stats=out_ab, fmt=fmt)
    return y


def s2fp8_quant_ref(x: torch.Tensor, fmt: str = "e5m2"):
    """(payload, alpha, beta) of ``x`` with its own exact stats."""
    t = s2fp8.quantize(x, fmt=fmt)
    return t.payload, t.alpha, t.beta


def selective_scan_ref(x, dt, bmat, cmat, a, d_skip):
    """Mamba-1 selective scan oracle, f32: x, dt [B,S,di]; bmat, cmat
    [B,S,n]; a [di,n]; d_skip [di] -> (y [B,S,di], h_final [B,di,n]).
    Per step h = h * exp(dt A) + (dt x) B and y = h.C + D x (reference
    ``ref.selective_scan_ref``)."""
    x, dt, bmat, cmat, a, d_skip = (t.float() for t in
                                    (x, dt, bmat, cmat, a, d_skip))
    b, s, di = x.shape
    h = torch.zeros((b, di, bmat.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(s):
        xt, dtt = x[:, t], dt[:, t]
        h = (h * torch.exp(dtt[:, :, None] * a)
             + (dtt * xt)[:, :, None] * bmat[:, t, None, :])
        ys.append(torch.einsum("bdn,bn->bd", h, cmat[:, t]) + d_skip * xt)
    return torch.stack(ys, dim=1), h


def selective_scan_heads_ref(x, dt, bmat, cmat, a, d_skip):
    """Mamba-2 (per-head) selective scan oracle, f32: x [B,S,nh*hd]; dt
    [B,S,nh]; bmat, cmat [B,S,n]; a, d_skip [nh] -> (y [B,S,nh*hd],
    h_final [B,nh*hd,n], the [B,nh,hd,n] state flattened).  Per step h = h
    * exp(dt A) + (dt x) B with one decay a (row, head), y = h.C + D x
    (reference blocks.py:724-729 step, then ``+ d_skip * x``)."""
    x, dt, bmat, cmat, a, d_skip = (t.float() for t in
                                    (x, dt, bmat, cmat, a, d_skip))
    b, s, di = x.shape
    nh, n = a.shape[0], bmat.shape[-1]
    xh = x.reshape(b, s, nh, di // nh)
    h = torch.zeros((b, nh, di // nh, n), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(s):
        xt, dtt = xh[:, t], dt[:, t]
        da = torch.exp(dtt * a)                                  # [B, nh]
        h = (h * da[:, :, None, None]
             + (dtt[:, :, None] * xt)[..., None] * bmat[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, cmat[:, t])
                  + d_skip[:, None] * xt)
    return torch.stack(ys, dim=1).reshape(b, s, di), h.reshape(b, di, n)


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None):
    """Softmax attention oracle in f32: q [B,H,Sq,D], k/v [B,H,Sk,D] (KV
    heads already broadcast), query rows aligned to the end of the key
    axis.  Masked logits are -inf, so a row that sees no key is NaN, as in
    the reference's ``ref.attention_ref``."""
    q, k, v = q.float(), k.float(), v.float()
    d = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    sq, sk = q.shape[2], k.shape[2]
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    probs = torch.softmax(logits.masked_fill(~mask, -math.inf), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)
