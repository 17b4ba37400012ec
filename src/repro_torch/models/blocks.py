"""Dense decoder blocks (port of the dense part of ``repro.models.blocks``).

Attention computes in the grouped layout [B, KV, G, S, hd] and every GEMM
goes through the policy.  Ported: RMS norm, SiLU-GLU, RoPE (scalar and
per-slot positions), ``full_attention`` (the payload flash fast path for
the s2fp8 modes, the masked softmax through ``policy.einsum`` for fp32 and
fp8), the MLP, and ``attn_block_apply``'s train, prefill and paged-decode
branches.  The dense-cache decode and the chunked path wait for later
slices, so sequences must stay <= 2048 (the reference switches to chunked
attention above that).

The layer params keep the reference's names and layout (weights
[d_in, d_out]), and every cast happens where the reference casts.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import statsbank
from repro_torch.core.policy import Policy

MAX_FULL_ATTENTION_SEQ = 2048
_MASK = -1e30


def init_norm(cfg: ArchConfig, dim: int, device=None) -> Dict[str, torch.Tensor]:
    if cfg.norm != "rms":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported")
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def apply_norm(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    y = y * p["scale"]
    return y.to(x.dtype)


def activate(h_gate: torch.Tensor, h_lin: torch.Tensor, activation: str):
    """SiLU-GLU as the reference computes it: XLA lowers ``jax.nn.silu`` to
    x * 1 / (1 + exp(-x)) and rounds to the activation dtype after each op,
    so the port does the same ops on the same dtype (a fused f32 SiLU
    rounds once and gives other bf16 values)."""
    if activation == "silu_glu":
        return h_gate * (1.0 / (1.0 + torch.exp(-h_gate))) * h_lin
    raise NotImplementedError(f"activation {activation!r} is not ported")


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, hd]; positions: [S] int, or [B, S] for per-slot decode."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., :, None] * freqs               # [..., S, half]
    if positions.dim() == 2:
        ang = ang.reshape(ang.shape[:1] + (1,) * (x.dim() - 3) + ang.shape[1:])
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)


def _grouped(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """[B, H, S, d] -> [B, KV, G, S, d]."""
    b, h, s, d = q.shape
    return q.reshape(b, kv_heads, h // kv_heads, s, d)


def full_attention(q, k, v, *, causal=True, window=None, policy: Policy):
    """q: [B,KV,G,Sq,d]; k,v: [B,KV,Sk,d].  Payload policies run the fused
    payload flash node; the others a plain masked softmax whose two
    contractions go through ``policy.einsum`` (reference blocks.py:117)."""
    if policy.uses_payload_gemm:
        return policy.flash_attention(q, k, v, causal=causal,
                                      window=window).to(q.dtype)
    d = q.shape[-1]
    sq, sk = q.shape[3], k.shape[2]
    logits = policy.einsum("bkgqd,bksd->bkgqs", q, k).float() / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    probs = torch.softmax(torch.where(mask, logits, _MASK), dim=-1)
    out = policy.einsum("bkgqs,bksd->bkgqd", probs, v).float()
    return out.to(q.dtype)


def init_mlp(cfg: ArchConfig, gen: torch.Generator, d_in: int, d_ff: int,
             device=None) -> Dict[str, torch.Tensor]:
    std_in, std_ff = 1.0 / math.sqrt(d_in), 1.0 / math.sqrt(d_ff)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    return {"w_gate": normal((d_in, d_ff), std_in),
            "w_down": normal((d_ff, d_in), std_ff),
            "w_up": normal((d_in, d_ff), std_in)}


def mlp_fwd(p, x, cfg: ArchConfig, pol: Policy):
    with statsbank.scope("mlp"):
        hg = pol.dot(x, p["w_gate"].to(x.dtype))
        hl = pol.dot(x, p["w_up"].to(x.dtype))
        h = activate(hg, hl, cfg.activation)
        return pol.dot(h, p["w_down"].to(x.dtype))


def init_attn_block(cfg: ArchConfig, gen: torch.Generator, device=None
                    ) -> Dict[str, Any]:
    """Same leaves and per-leaf std as the reference's init_attn_block."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.kv_heads
    std, std_o = 1.0 / math.sqrt(d), 1.0 / math.sqrt(h * hd)

    def normal(shape, s):
        return torch.randn(shape, generator=gen, device=device) * s

    return {
        "ln1": init_norm(cfg, d, device),
        "wq": normal((d, h * hd), std),
        "wk": normal((d, kv * hd), std),
        "wv": normal((d, kv * hd), std),
        "wo": normal((h * hd, d), std_o),
        "ln2": init_norm(cfg, d, device),
        "mlp": init_mlp(cfg, gen, d, cfg.d_ff, device),
    }


def attn_block_apply(p, x: torch.Tensor, cfg: ArchConfig, pol: Policy,
                     positions: torch.Tensor, cache, cache_index, mode: str,
                     cache_fmt: Optional[str] = None):
    """One dense block.  ``mode="train"`` attends over the sequence and
    keeps no cache; ``mode="prefill"`` also fills the dense cache ``cache``
    ({"k","v"} [B, KV, Smax, hd], written in place) with the kv_cache-site
    truncated K/V; ``mode="decode"`` writes into and attends over the paged
    payload cache (serving/paged_cache.py).  Returns (x, cache)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.kv_heads

    xn = apply_norm(p["ln1"], x, cfg)
    with statsbank.scope("attn"):
        q = pol.dot(xn, p["wq"].to(x.dtype)).reshape(b, s, h, hd).transpose(1, 2)
        k = pol.dot(xn, p["wk"].to(x.dtype)).reshape(b, s, kvh, hd).transpose(1, 2)
        v = pol.dot(xn, p["wv"].to(x.dtype)).reshape(b, s, kvh, hd).transpose(1, 2)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    qg = _grouped(q, kvh)

    if mode == "decode":
        from repro_torch.serving import paged_cache as _paged
        if s != 1 or cache is None or "kp" not in cache:
            raise ValueError("decode runs one token against a paged cache")
        attn, cache = _paged.update_and_attend(
            qg, k, v, cache, cache_index, policy=pol, cache_fmt=cache_fmt)
    elif mode in ("train", "prefill"):
        if s > MAX_FULL_ATTENTION_SEQ:
            raise NotImplementedError(
                f"{mode} over {s} > {MAX_FULL_ATTENTION_SEQ} tokens needs "
                f"the chunked attention path, which is not ported")
        attn = full_attention(qg, k, v, causal=True, policy=pol)
        if mode == "prefill" and cache is not None:
            # kv_cache/t{0,1} sites: the cache holds grid-snapped values, so
            # the payload re-encode at pack time is lossless
            with statsbank.scope("kv_cache"):
                k_store = pol.truncate(k)
                v_store = pol.truncate(v)
            for key, val in (("k", k_store), ("v", v_store)):
                cache[key][:, :, :s] = val
                cache[key][:, :, s:] = 0.0
    else:
        raise ValueError(f"mode {mode!r} is not ported "
                         f"(train/prefill/decode)")

    attn = attn.reshape(b, h, s, hd).transpose(1, 2).reshape(b, s, h * hd)
    with statsbank.scope("attn"):
        x = x + pol.dot(attn, p["wo"].to(x.dtype))
    xn2 = apply_norm(p["ln2"], x, cfg)
    x = x + mlp_fwd(p["mlp"], xn2, cfg, pol)
    return x, cache
