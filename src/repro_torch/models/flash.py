"""Chunked attention with a flash-style recompute backward (port of
``repro.models.flash``).

The naive chunked attention (``blocks.chunked_attention``) is
differentiated op by op, so its backward keeps every chunk pair's score,
probability and correction tensors.  Here the forward keeps only the
output and the rowwise logsumexp (beside its inputs), and the backward
recomputes each score tile from q, k and lse, with flash-2's identity
D = rowsum(dout * out) for the softmax's cotangent: residual memory
O(S) instead of O(S^2), for one more Q K^T per tile.

The reference computes this in plain JAX, outside any Pallas kernel, and
so does the port in plain torch on every device: the forward is the
grouped flash loop of ``kernels.flash_attention.flash_fwd_reference`` and
the backward its ``flash_bwd_reference``, in the reference's loop order
(query chunks outer, key chunks inner; dq summed over the key chunks, dk
and dv over the query chunks).  The payload path does not come here: a
payload policy's ``flash_attention`` runs the flash kernels.

Layout as ``blocks.chunked_attention``: q [B, KV, G, Sq, d], k/v [B, KV,
Sk, d]; the output is in q's dtype.  Sq and Sk must be multiples of their
chunks (``min(chunk, S)``), as the reference asserts.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import (flash_bwd_reference,
                                                 flash_fwd_reference)


def check_chunks(sq: int, sk: int, q_chunk: int, kv_chunk: int):
    """(q chunk, kv chunk) clipped to the sequences; raises where a
    sequence is not a multiple of its chunk (the reference asserts)."""
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, sk)
    if sq % q_chunk or sk % kv_chunk:
        raise ValueError(f"chunked attention wants Sq % {q_chunk} == 0 and "
                         f"Sk % {kv_chunk} == 0, got Sq {sq}, Sk {sk}")
    return q_chunk, kv_chunk


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk):
        out, lse = flash_fwd_reference(q, k, v, causal=causal, window=window,
                                       q_chunk=q_chunk, kv_chunk=kv_chunk)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.meta = (causal, window, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_chunk, kv_chunk = ctx.meta
        dout = dout.float()
        delta = (dout * out.float()).sum(dim=-1, keepdim=True)
        dq, dk, dv = flash_bwd_reference(q, k, v, dout, lse, delta,
                                         causal=causal, window=window,
                                         q_chunk=q_chunk, kv_chunk=kv_chunk)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    q_chunk: int = 1024, kv_chunk: int = 1024
                    ) -> torch.Tensor:
    """Attention of q [B, KV, G, Sq, d] over k/v [B, KV, Sk, d] in chunks
    of ``q_chunk`` x ``kv_chunk``, causal and/or within ``window`` keys,
    with the recompute backward (reference ``flash_attention``)."""
    q_chunk, kv_chunk = check_chunks(q.shape[3], k.shape[2], q_chunk,
                                     kv_chunk)
    return _FlashAttention.apply(q, k, v, causal, window, q_chunk, kv_chunk)
