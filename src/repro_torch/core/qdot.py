"""Payload-domain GEMM and flash-attention nodes, forward only.

Port of the serving part of ``repro.core.qdot``: ``_qdot_frozen``
(qdot.py:220), ``_qflash_frozen`` (:544) and the forward of the banked
node (``_qdot_banked`` / ``_qflash_banked`` at a refresh step), which is
how calibration runs.  ``qdot_train`` and ``qflash_attention`` keep their
names; the ``torch.autograd.Function`` versions come with training.

Forward of a GEMM node::

    qA = quantize(A, a.fwd stats)    # 1 B/elt payloads
    qB = quantize(B, b.fwd stats)
    Y  = qmatmul(qA, qB, epilogue_stats=out.fwd stats)

Operands are quantized in the dtype the caller passes (bf16 activations
and weights): the reference casts them to f32 first, which is exact, so
the payloads are the same.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import backend as nbackend
from repro_torch.core import statsbank
from repro_torch.core.s2fp8 import S2FP8Tensor
from repro_torch.kernels import flash_attention as _fkern


def _session(what: str) -> statsbank.Session:
    sess = statsbank.current_session()
    if sess is None:
        raise ValueError(f"{what} runs inside a frozen (serving) or "
                         f"calibrating StatsBank session in this port")
    return sess


def _qdot_frozen(be, fmt, a, b, site: statsbank.Site):
    """Frozen-stats forward: zero stats reductions."""
    qa = be.quantize(a, stats=site.frozen("a.fwd", fmt), fmt=fmt)
    qb = be.quantize(b, stats=site.frozen("b.fwd", fmt), fmt=fmt)
    return be.qmatmul(qa, qb, layout="nn",
                      epilogue_stats=site.frozen("out.fwd", fmt), fmt=fmt)


def _qdot_calibrate(be, fmt, backend, a, b, site: statsbank.Site):
    """Refresh-step forward: operand stats refreshed from the operands, the
    raw product computed, the output stats refreshed from it, then the
    output truncated with them (refresh-then-use)."""
    qa = be.quantize(a, stats=site.refresh("a.fwd", a, fmt, backend), fmt=fmt)
    qb = be.quantize(b, stats=site.refresh("b.fwd", b, fmt, backend), fmt=fmt)
    y_raw = be.qmatmul(qa, qb, layout="nn", fmt=fmt)
    ab = site.refresh("out.fwd", y_raw, fmt, backend)
    return be.truncate(y_raw, stats=ab, fmt=fmt)


def qdot_train(a: torch.Tensor, b: torch.Tensor, *,
               backend: Optional[str] = None, fmt: str = "e5m2"
               ) -> torch.Tensor:
    """Payload-domain ``[..., K] x [K, N] -> [..., N]`` in f32, one bank
    node (site kind ``qt``) of the active session."""
    if b.dim() != 2 or a.dim() < 1 or a.shape[-1] != b.shape[0]:
        raise ValueError(f"qdot_train wants [..., K] x [K, N]; got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    out_shape = a.shape[:-1] + (b.shape[-1],)
    a2 = a.reshape(-1, a.shape[-1])
    sess = _session("qdot_train")
    be = nbackend.get_backend(backend)
    site = sess.site("qt")
    if sess.frozen:
        y2 = _qdot_frozen(be, fmt, a2, b, site)
    else:
        y2 = _qdot_calibrate(be, fmt, backend, a2, b, site)
    return y2.reshape(out_shape)


def _payload_flash_fwd(be, qq: S2FP8Tensor, qk: S2FP8Tensor, qv: S2FP8Tensor,
                       causal, window, fmt, bq, bk, out_stats):
    """Raw payload flash forward -> (out f32 [B,KV,G,Sq,d], lse).

    ``cuda`` engine: the fused kernel (epilogue truncation in the kernel
    when ``out_stats`` is given).  ``plain`` engine: dequantize + the
    grouped flash reference, then an elementwise truncate."""
    b, kvh, g, sq, d = qq.payload.shape
    sk = qk.payload.shape[2]
    if isinstance(be, nbackend.CudaBackend):
        out, lse = _fkern.qflash_fwd(
            qq.payload.reshape(b * kvh * g, sq, d),
            qk.payload.reshape(b * kvh, sk, d),
            qv.payload.reshape(b * kvh, sk, d), qq.ab, qk.ab, qv.ab, g=g,
            causal=causal, window=window, scale=1.0 / math.sqrt(d),
            out_ab=out_stats, fmt=fmt)
        return (out.reshape(b, kvh, g, sq, d),
                lse.reshape(b, kvh, g, sq, 1))
    out, lse = _fkern.flash_fwd_reference(
        be.dequantize(qq), be.dequantize(qk), be.dequantize(qv),
        causal=causal, window=window, q_chunk=bq, kv_chunk=bk)
    if out_stats is not None:
        out = be.truncate(out, stats=out_stats, fmt=fmt)
    return out, lse


def qflash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: Optional[int] = None,
                     backend: Optional[str] = None, fmt: str = "e5m2",
                     q_chunk: int = 512, kv_chunk: int = 512
                     ) -> torch.Tensor:
    """Payload-domain flash attention, q ``[B, KV, G, Sq, d]``, k/v
    ``[B, KV, Sk, d]``; one bank node (site kind ``qf``).  Returns f32."""
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"qflash_attention wants q [B,KV,G,Sq,d], "
                         f"k/v [B,KV,Sk,d]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if (k.shape != v.shape or q.shape[:2] != k.shape[:2]
            or q.shape[-1] != k.shape[-1]):
        raise ValueError(f"inconsistent attention shapes: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    sess = _session("qflash_attention")
    be = nbackend.get_backend(backend)
    site = sess.site("qf")
    if sess.frozen:
        qq = be.quantize(q, stats=site.frozen("q.fwd", fmt), fmt=fmt)
        qk = be.quantize(k, stats=site.frozen("k.fwd", fmt), fmt=fmt)
        qv = be.quantize(v, stats=site.frozen("v.fwd", fmt), fmt=fmt)
        out, _ = _payload_flash_fwd(be, qq, qk, qv, causal, window, fmt,
                                    q_chunk, kv_chunk,
                                    site.frozen("out.fwd", fmt))
        return out
    qq = be.quantize(q, stats=site.refresh("q.fwd", q, fmt, backend), fmt=fmt)
    qk = be.quantize(k, stats=site.refresh("k.fwd", k, fmt, backend), fmt=fmt)
    qv = be.quantize(v, stats=site.refresh("v.fwd", v, fmt, backend), fmt=fmt)
    raw, _ = _payload_flash_fwd(be, qq, qk, qv, causal, window, fmt,
                                q_chunk, kv_chunk, None)
    ab = site.refresh("out.fwd", raw, fmt, backend)
    return be.truncate(raw, stats=ab, fmt=fmt)
