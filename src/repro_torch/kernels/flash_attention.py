"""Flash attention: the payload forward and backward and the plain
forward, CUDA kernels + plain versions.

``qflash_fwd`` replaces ``qflash_fwd_pallas`` (_qflash_fwd_kernel,
_attn_mask), ``qflash_bwd`` replaces ``qflash_bwd_pallas``
(_qflash_dq_kernel, _qflash_dkdv_kernel) and ``flash_attention`` replaces
``flash_attention_pallas`` (_flash_kernel) of
``src/repro/kernels/flash_attention.py``.  Kernel source:
``repro_torch/csrc/flash_attention.cu``; the plain forward is the payload
forward's tile loop instantiated for f32 or bf16 loads, without the
dequantize, the logsumexp and the Eq. 5 epilogue.

Every product runs on TF32 tensor cores (``mma.sync`` m16n8k8) in
three passes over a (hi, lo) split of each f32 operand (``ref.split_tf32``;
payloads take the pair from a per-block table of every code), so the
kernels keep the f32 tolerances of their plain versions.  Bound on the
card: operations (QK^T and PV forward; five products per visible pair
backward; halved by a causal mask), the least time 3x the FLOPs at the
TF32 rate.  Forward design: one block per (query head, 64 query rows),
each warp 16 rows; K/V tiles land in shared memory with double-buffered
``cp.async`` (payloads as bytes), the score tile and the online-softmax
state stay in registers, fully masked tiles are skipped, and the fused
Eq. 5 epilogue truncates the output before its one write.  Backward
design: the recompute schedule from the payloads plus lse — a dq kernel
(one block per 64 query rows, key tiles innermost) and a dk/dv kernel (one
block per 64 key rows, query tiles innermost) that writes per-query-head
dk/dv; the sum over a K/V head's G query heads is done outside
(``dispatch.qflash_bwd_grouped``), so no float atomics and two launches
give the same bits.  Head dims 1..256 (zero-padded to a multiple of 16 in
shared memory, which is exact); above 128 each block accumulates one of
two column halves of the output (or of dq, or of dk and dv) and forms the
score tiles from the full head dim.

``flash_fwd_reference`` / ``flash_bwd_reference`` are ports of the
reference's pure-jnp grouped flash forward and backward; the plain
versions run them on dequantized payloads, which is the reference
engine's own route.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import s2fp8
from repro_torch.kernels import build, kernel_entry, plain_version, ref
from repro_torch.kernels.s2fp8_quant import (DTYPE_ID, FMT_ID, PAYLOAD_FMT,
                                             check_cuda_operand, stats_arg)

_MASK_VALUE = -1e30
MAX_HEAD_DIM = 256     # the kernels' DMAX


def _chunk(block: int, s: int) -> int:
    """Largest block <= ``block`` that divides the sequence length."""
    return math.gcd(min(block, s), s)


def _chunk_mask(iq, ik, q_chunk, kv_chunk, sq, sk, causal, window, device):
    qpos = (iq * q_chunk + torch.arange(q_chunk, device=device)[:, None]
            + (sk - sq))
    kpos = ik * kv_chunk + torch.arange(kv_chunk, device=device)[None, :]
    mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def flash_fwd_reference(q, k, v, *, causal=True, window=None, q_chunk=512,
                        kv_chunk=512, scale: Optional[float] = None):
    """Grouped flash forward, f32: q [B,KV,G,Sq,d], k/v [B,KV,Sk,d] ->
    (out [B,KV,G,Sq,d], lse [B,KV,G,Sq,1]).  Op-for-op port of
    ``repro.kernels.flash_attention.flash_fwd_reference``."""
    b, kvh, g, sq, d = q.shape
    sk = k.shape[2]
    q_chunk = _chunk(q_chunk, sq)
    kv_chunk = _chunk(kv_chunk, sk)
    nq, nk = sq // q_chunk, sk // kv_chunk
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    outs, lses = [], []
    for iq in range(nq):
        qi = q[:, :, :, iq * q_chunk:(iq + 1) * q_chunk].float()
        m = torch.full((b, kvh, g, q_chunk, 1), _MASK_VALUE,
                       dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kvh, g, q_chunk, 1), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, kvh, g, q_chunk, d), dtype=torch.float32,
                          device=q.device)
        for ik in range(nk):
            ki = k[:, :, ik * kv_chunk:(ik + 1) * kv_chunk].float()
            vi = v[:, :, ik * kv_chunk:(ik + 1) * kv_chunk].float()
            s = torch.einsum("bkgqd,bksd->bkgqs", qi, ki) * scale
            mask = _chunk_mask(iq, ik, q_chunk, kv_chunk, sq, sk, causal,
                               window, q.device)
            s = torch.where(mask, s, _MASK_VALUE)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum("bkgqs,bksd->bkgqd", p, vi)
            m = m_new
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
        outs.append(acc / torch.where(l == 0.0, 1.0, l))
    return torch.cat(outs, dim=3), torch.cat(lses, dim=3)


def flash_bwd_reference(q, k, v, dout, lse, delta, *, causal=True,
                        window=None, q_chunk=512, kv_chunk=512,
                        scale: Optional[float] = None):
    """Grouped flash backward over precomputed (lse, delta), f32: q/dout
    [B,KV,G,Sq,d], k/v [B,KV,Sk,d], lse/delta [B,KV,G,Sq,1] ->
    (dq, dk, dv) with dk/dv summed over the G query heads.  Op-for-op port
    of ``repro.kernels.flash_attention.flash_bwd_reference``."""
    b, kvh, g, sq, d = q.shape
    sk = k.shape[2]
    q_chunk = _chunk(q_chunk, sq)
    kv_chunk = _chunk(kv_chunk, sk)
    nq, nk = sq // q_chunk, sk // kv_chunk
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    dout = dout.float()
    dq = torch.zeros((b, kvh, g, sq, d), dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros((b, kvh, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for iq in range(nq):
        qs = slice(iq * q_chunk, (iq + 1) * q_chunk)
        qi, di = q[:, :, :, qs].float(), dout[:, :, :, qs]
        li, deli = lse[:, :, :, qs], delta[:, :, :, qs]
        for ik in range(nk):
            ks = slice(ik * kv_chunk, (ik + 1) * kv_chunk)
            ki, vi = k[:, :, ks].float(), v[:, :, ks].float()
            s = torch.einsum("bkgqd,bksd->bkgqs", qi, ki) * scale
            mask = _chunk_mask(iq, ik, q_chunk, kv_chunk, sq, sk, causal,
                               window, q.device)
            s = torch.where(mask, s, _MASK_VALUE)
            p = torch.where(mask, torch.exp(s - li), 0.0)
            dv[:, :, ks] += torch.einsum("bkgqs,bkgqd->bksd", p, di)
            dp = torch.einsum("bkgqd,bksd->bkgqs", di, vi)
            ds = p * (dp - deli) * scale
            dq[:, :, :, qs] += torch.einsum("bkgqs,bksd->bkgqd", ds, ki)
            dk[:, :, ks] += torch.einsum("bkgqs,bkgqd->bksd", ds, qi)
    return dq, dk, dv


def _check_shapes(qp, kp, vp, g):
    if qp.dim() != 3 or kp.dim() != 3 or kp.shape != vp.shape:
        raise ValueError(f"qflash wants q [BH,Sq,d], k/v [BKV,Sk,d]; got "
                         f"{tuple(qp.shape)}, {tuple(kp.shape)}, "
                         f"{tuple(vp.shape)}")
    if qp.shape[0] != kp.shape[0] * g or qp.shape[2] != kp.shape[2]:
        raise ValueError(f"inconsistent grouped shapes {tuple(qp.shape)} / "
                         f"{tuple(kp.shape)} with g={g}")


@plain_version
def qflash_fwd_plain(qp, kp, vp, q_ab, k_ab, v_ab, *, g: int, causal=True,
                     window=None, scale=None, out_ab=None, fmt="e5m2",
                     q_chunk=512, kv_chunk=512):
    """Plain version: dequantize, ``flash_fwd_reference``, then the Eq. 5
    truncation of the output with ``out_ab``."""
    _check_shapes(qp, kp, vp, g)
    bh, sq, d = qp.shape
    bkv, sk, _ = kp.shape
    q = ref.s2fp8_dequant_ref(qp, q_ab).reshape(1, bkv, g, sq, d)
    k = ref.s2fp8_dequant_ref(kp, k_ab).reshape(1, bkv, sk, d)
    v = ref.s2fp8_dequant_ref(vp, v_ab).reshape(1, bkv, sk, d)
    out, lse = flash_fwd_reference(q, k, v, causal=causal, window=window,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk,
                                   scale=scale)
    out = out.reshape(bh, sq, d)
    if out_ab is not None:
        out = ref.s2fp8_truncate_ref(out, stats=out_ab, fmt=fmt)
    return out, lse.reshape(bh, sq)


@kernel_entry("qflash_fwd")
def qflash_fwd(qp, kp, vp, q_ab, k_ab, v_ab, *, g: int, causal=True,
               window=None, scale=None, out_ab=None, fmt="e5m2"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Payload flash forward.  qp: [BH, Sq, d] float8 with BH = B*KV*G;
    kp/vp: [B*KV, Sk, d]; query head h reads K/V head h // g.  Returns
    (out f32 [BH, Sq, d], lse f32 [BH, Sq]); with ``out_ab`` the output
    carries the fused Eq. 5 epilogue.  CPU tensors take the plain version."""
    _check_shapes(qp, kp, vp, g)
    if qp.device.type == "cpu":
        return qflash_fwd_plain(qp, kp, vp, q_ab, k_ab, v_ab, g=g,
                                causal=causal, window=window, scale=scale,
                                out_ab=out_ab, fmt=fmt)
    for name, t in (("q", qp), ("k", kp), ("v", vp)):
        check_cuda_operand(t, name, (s2fp8.FMT_QDTYPE[fmt],), qp.device)
    bh, sq, d = qp.shape
    sk = kp.shape[1]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"qflash kernel takes head dims 1..{MAX_HEAD_DIM}, "
                         f"got {d}")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    dev = qp.device
    qab, kab, vab = (stats_arg(s, dev) for s in (q_ab, k_ab, v_ab))
    oab = None if out_ab is None else stats_arg(out_ab, dev)
    out = torch.empty((bh, sq, d), dtype=torch.float32, device=dev)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=dev)
    rc = build.load("flash_attention").s2fp8_qflash_fwd(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, sq, sk, d, g, qab.data_ptr(), kab.data_ptr(),
        vab.data_ptr(), build.ptr(oab), int(oab is not None), int(causal),
        int(window or 0), scale, FMT_ID[fmt], build.stream_ptr(dev))
    build.check(rc, "s2fp8_qflash_fwd")
    qflash_fwd.launches += 1
    return out, lse


@plain_version
def qflash_bwd_plain(qp, kp, vp, gp, q_ab, k_ab, v_ab, g_ab, lse, delta, *,
                     g: int, causal=True, window=None, scale=None,
                     q_chunk=512, kv_chunk=512):
    """Plain version: dequantize, then ``flash_bwd_reference`` with every
    query head given its own copy of its K/V head, which yields the
    per-head dk/dv the kernel writes."""
    _check_shapes(qp, kp, vp, g)
    bh, sq, d = qp.shape
    sk = kp.shape[1]

    def per_head(p, ab):
        return ref.s2fp8_dequant_ref(p, ab).repeat_interleave(
            g, dim=0).reshape(1, bh, sk, d)

    q = ref.s2fp8_dequant_ref(qp, q_ab).reshape(1, bh, 1, sq, d)
    dout = ref.s2fp8_dequant_ref(gp, g_ab).reshape(1, bh, 1, sq, d)
    dq, dk, dv = flash_bwd_reference(
        q, per_head(kp, k_ab), per_head(vp, v_ab), dout,
        lse.reshape(1, bh, 1, sq, 1), delta.reshape(1, bh, 1, sq, 1),
        causal=causal, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
        scale=scale)
    return dq.reshape(bh, sq, d), dk.reshape(bh, sk, d), dv.reshape(bh, sk, d)


@kernel_entry("qflash_bwd")
def qflash_bwd(qp, kp, vp, gp, q_ab, k_ab, v_ab, g_ab, lse, delta, *,
               g: int, causal=True, window=None, scale=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Payload flash backward.  qp, gp: [BH, Sq, d] float8 (gp is the
    quantized output cotangent); kp/vp: [B*KV, Sk, d]; lse, delta: [BH, Sq]
    f32.  Returns raw f32 (dq [BH, Sq, d], dk [BH, Sk, d], dv [BH, Sk, d])
    with dk/dv per query head.  CPU tensors take the plain version."""
    _check_shapes(qp, kp, vp, g)
    if gp.shape != qp.shape or lse.shape != qp.shape[:2] \
            or delta.shape != qp.shape[:2]:
        raise ValueError(f"qflash_bwd wants gp {tuple(qp.shape)} and "
                         f"lse/delta {tuple(qp.shape[:2])}; got "
                         f"{tuple(gp.shape)}, {tuple(lse.shape)}, "
                         f"{tuple(delta.shape)}")
    if qp.device.type == "cpu":
        return qflash_bwd_plain(qp, kp, vp, gp, q_ab, k_ab, v_ab, g_ab, lse,
                                delta, g=g, causal=causal, window=window,
                                scale=scale)
    check_cuda_operand(qp, "q", tuple(PAYLOAD_FMT))
    fmt = PAYLOAD_FMT[qp.dtype]
    for name, t in (("k", kp), ("v", vp), ("g", gp)):
        check_cuda_operand(t, name, (qp.dtype,), qp.device)
    for name, t in (("lse", lse), ("delta", delta)):
        check_cuda_operand(t, name, (torch.float32,), qp.device)
    bh, sq, d = qp.shape
    sk = kp.shape[1]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"qflash kernel takes head dims 1..{MAX_HEAD_DIM}, "
                         f"got {d}")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    dev = qp.device
    qab, kab, vab, gab = (stats_arg(s, dev) for s in (q_ab, k_ab, v_ab, g_ab))
    dq = torch.empty((bh, sq, d), dtype=torch.float32, device=dev)
    dk = torch.empty((bh, sk, d), dtype=torch.float32, device=dev)
    dv = torch.empty_like(dk)
    rc = build.load("flash_attention").s2fp8_qflash_bwd(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), gp.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), bh, sq, sk, d, g, qab.data_ptr(), kab.data_ptr(),
        vab.data_ptr(), gab.data_ptr(), int(causal), int(window or 0), scale,
        FMT_ID[fmt], build.stream_ptr(dev))
    build.check(rc, "s2fp8_qflash_bwd")
    qflash_bwd.launches += 1
    return dq, dk, dv


def _check_plain(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention wants q [B,H,Sq,D], k/v "
                         f"[B,H,Sk,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive number of keys, got "
                         f"{window}")


@plain_version
def flash_attention_plain(q, k, v, *, causal=True, window=None
                          ) -> torch.Tensor:
    """Plain version: ``flash_fwd_reference`` with one query head per K/V
    head; the output in q's dtype."""
    _check_plain(q, k, v, window)
    out, _ = flash_fwd_reference(q[:, :, None], k, v, causal=causal,
                                 window=window)
    return out[:, :, 0].to(q.dtype)


@kernel_entry("flash_fwd")
def flash_attention(q, k, v, *, causal=True, window=None) -> torch.Tensor:
    """Flash attention forward over values: q [B, H, Sq, D], k/v [B, H,
    Sk, D] (K/V heads already broadcast), all f32 or all bf16, contiguous,
    D <= 256; causal and/or windowed, query rows aligned to the end of the
    key axis.  Accumulates in f32 and returns q's dtype; a row that sees no
    key gives 0.  CPU tensors take the plain version."""
    _check_plain(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    check_cuda_operand(q, "q", tuple(DTYPE_ID))
    for name, t in (("k", k), ("v", v)):
        check_cuda_operand(t, name, (q.dtype,), q.device)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash kernel takes head dims 1..{MAX_HEAD_DIM}, "
                         f"got {d}")
    out = torch.empty_like(q)
    rc = build.load("flash_attention").flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, sq,
        sk, d, DTYPE_ID[q.dtype], int(causal), int(window or 0),
        1.0 / math.sqrt(d), build.stream_ptr(q.device))
    build.check(rc, "flash_fwd")
    flash_attention.launches += 1
    return out


qflash_fwd.launches = 0
qflash_bwd.launches = 0
flash_attention.launches = 0
