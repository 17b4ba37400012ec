"""Decoder blocks (port of the attention-bearing and Mamba-1 parts of
``repro.models.blocks``).

Attention computes in the grouped layout [B, KV, G, S, hd] and every GEMM
goes through the policy.  Ported: RMS and layer norm, SiLU-GLU, GELU-GLU,
the tanh GELU and the squared ReLU (the last two with the non-GLU MLP,
which has no ``w_up``), RoPE (scalar and
per-slot positions), ``full_attention`` (the payload flash fast path for
payload policies, the masked softmax through ``policy.einsum`` for the
others), ``chunked_attention`` (the doubly chunked online softmax in f32,
differentiated op by op) and ``decode_attention`` (one token against a
dense cache), the MLP, the MoE (token-choice top-k routing with capacity,
global or grouped per batch row, shared experts, the load-balance aux
loss), and ``attn_block_apply``'s train, prefill, dense-cache decode and
paged decode for the ``dense``, ``local``, ``attn``, ``dense_first`` and
``moe`` block types, and the encoder-decoder's non-causal ``encoder``
block.
Above 2048 tokens a block attends through ``Policy.flash_attention`` when
``cfg.attn_impl == "flash"`` (on the payload path the payload flash
node, else ``models/flash.py``) and through ``chunked_attention``
otherwise, as the reference does.  A ``local`` block attends within
``cfg.window`` keys (window masks, the ring-buffer decode cache of
``min(max_len, window)`` positions, the window prefill cache), every other
type globally; ``attn`` is the reference's attention block with its MLP,
as ``dense``.

Mamba-1 (``mamba1``) and Mamba-2 (``mamba2``, multi-head with one
scalar decay a head): ``init_mamba1`` / ``init_mamba2`` and
``mamba1_apply`` / ``mamba2_apply`` in training, prefill and single-token
decode over a dense {conv, ssm} cache.  Training and prefill run the
selective-scan kernel (kernels/selective_scan.py; training through
``SelectiveScanFn``, whose backward is the scan's backward kernel) for
every ``cfg.ssm_impl`` schedule: the reference's "step", "unroll8" and
"ssd" compute the same function in other orders.  Decode is the
reference's single recurrence step in plain torch ops, as the reference
computes it outside any kernel.  ``init_block``, ``block_apply`` and
``init_cache`` dispatch by block type as the reference's do.

The layer params keep the reference's names and layout (weights
[d_in, d_out]), and every cast happens where the reference casts.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives, statsbank
from repro_torch.core.collectives import TpSpec
from repro_torch.core.policy import Policy
from repro_torch.kernels import selective_scan as scan
from repro_torch.kernels.flash_attention import flash_fwd_reference
from repro_torch.models.flash import check_chunks
from repro_torch.parallel import sharding as shd

LONG_SEQ = 2048        # above this, chunked or flash attention
_MASK = -1e30
# the block types whose attention and MLP split over the model axis (the
# MoE experts, the Mamba blocks and the encoder-decoder replicate)
TP_BLOCK_TYPES = ("dense", "local", "attn", "dense_first")


class AttnSplit(NamedTuple):
    """An attention block's split over the model axis: its query heads
    (``heads``), its K/V heads (``kv``, None when they stay whole) and,
    with whole K/V, the one K/V head this rank's query heads use
    (``pick``)."""
    heads: shd.Split
    kv: Optional[shd.Split]
    pick: Optional[int]


def attn_split(cfg: ArchConfig, block_type: str) -> Optional[AttnSplit]:
    """The model-axis split of a block's attention under the active rules
    (``parallel.sharding.split`` of ``heads`` and ``kv``), or None.  Query
    heads split where ``heads`` does; K/V heads where ``kv`` does too,
    else each rank attends with the one whole K/V head of its query heads
    (GQA), or the heads stay whole where a rank's query heads would span
    several K/V heads."""
    if block_type not in TP_BLOCK_TYPES:
        return None
    h, kvh = cfg.n_heads, cfg.kv_heads
    hs = shd.split("heads", h)
    if hs is None:
        return None
    kvs = shd.split("kv", kvh)
    if kvs is not None and kvs.axis == hs.axis:
        return AttnSplit(hs, kvs, None)
    g, hl = h // kvh, h // hs.size
    if g % hl:
        return None
    return AttnSplit(hs, None, hs.coord * hl // g)


def mlp_split(cfg: ArchConfig, block_type: str, d_ff: int
              ) -> Optional[shd.Split]:
    """The model-axis split of a block's MLP hidden dim (``mlp``)."""
    if block_type not in TP_BLOCK_TYPES:
        return None
    return shd.split("mlp", d_ff)


def col_tp(sp: Optional[shd.Split]) -> Optional[TpSpec]:
    """Column-parallel: the input whole, the weight's columns and the
    output split."""
    return None if sp is None else TpSpec(sp.axis, "full", "split", "split")


def row_tp(sp: Optional[shd.Split]) -> Optional[TpSpec]:
    """Row-parallel: the input and the weight's rows split, the output a
    partial sum."""
    return None if sp is None else TpSpec(sp.axis, "split", "split",
                                          "partial")


def init_norm(cfg: ArchConfig, dim: int, device=None) -> Dict[str, torch.Tensor]:
    """RMS norm: a scale; layer norm (``norm="ln"``): a scale and a bias."""
    if cfg.norm not in ("rms", "ln"):
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported")
    p = {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}
    if cfg.norm == "ln":
        p["bias"] = torch.zeros((dim,), dtype=torch.float32, device=device)
    return p


def apply_norm(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """In f32, cast back to x's dtype.  Layer norm: the population variance
    (``jnp.var``: the mean of the squared deviations from the mean), eps
    1e-6."""
    xf = x.float()
    if cfg.norm == "ln":
        mean = xf.mean(dim=-1, keepdim=True)
        c = xf - mean
        var = (c * c).mean(dim=-1, keepdim=True)
        y = c * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]
    else:
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
        y = y * p["scale"]
    return y.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (``approximate=True``, its default; torch's default
    is the exact erf form) in the reference's op order, x * (0.5 * (1 +
    tanh(c * (x + k * x^3)))), one op at a time in x's dtype: c =
    sqrt(2/pi) and k = 0.044715 are rounded to x's dtype first, as JAX
    casts them, and x^3 is x * (x * x), as XLA lowers ``x ** 3``."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype,
                     device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    cube = x * (x * x)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * cube))))


def activate(h_gate: torch.Tensor, h_lin: Optional[torch.Tensor],
             activation: str):
    """The reference's activations, op by op in the activation dtype.
    SiLU-GLU: XLA lowers ``jax.nn.silu`` to x * 1 / (1 + exp(-x)) and
    rounds to the activation dtype after each op, so the port does the
    same ops on the same dtype (a fused f32 SiLU rounds once and gives
    other bf16 values).  ``gelu_glu``: :func:`gelu_tanh` of the gate times
    the linear half.  ``gelu``: the tanh approximation, no gate.
    ``sq_relu`` (Nemotron-4): relu(gate), squared, no gate."""
    if activation == "silu_glu":
        return h_gate * (1.0 / (1.0 + torch.exp(-h_gate))) * h_lin
    if activation == "gelu_glu":
        return gelu_tanh(h_gate) * h_lin
    if activation == "gelu":
        return gelu_tanh(h_gate)
    if activation == "sq_relu":
        r = torch.relu(h_gate)
        return r * r
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


def _attn_einsum(policy: Optional[Policy], spec: str, a, b,
                 tp: Optional[TpSpec] = None):
    """An attention contraction through the policy (its result in f32),
    or an f32 einsum without one (reference ``_attn_einsum``); ``tp``
    (a model-axis split, which the models run through a policy) as in
    ``Policy.einsum``."""
    if policy is None:
        if tp is not None:
            raise ValueError("a split attention runs through a policy")
        return torch.einsum(spec, a.float(), b.float())
    return policy.einsum(spec, a, b, tp=tp).float()


def _score_tp(tp: Optional[TpSpec]) -> Optional[TpSpec]:
    """The P.V contraction's split of a heads-split attention: the
    probabilities split as the scores, V as K."""
    return None if tp is None else tp._replace(a="split")


def full_attention(q, k, v, *, causal=True, window=None,
                   policy: Optional[Policy] = None,
                   tp: Optional[TpSpec] = None):
    """q: [B,KV,G,Sq,d]; k,v: [B,KV,Sk,d].  Payload policies run the fused
    payload flash node; the others a plain masked softmax whose two
    contractions go through ``policy.einsum`` (reference blocks.py:117).
    ``tp``: the rank's query heads of a heads-split attention (q split;
    K/V split, or whole with ``b_pick``), each rank's softmax over its own
    heads."""
    if policy is not None and policy.uses_payload_gemm:
        return policy.flash_attention(q, k, v, causal=causal,
                                      window=window, tp=tp).to(q.dtype)
    d = q.shape[-1]
    sq, sk = q.shape[3], k.shape[2]
    logits = _attn_einsum(policy, "bkgqd,bksd->bkgqs", q, k, tp) \
        / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    probs = torch.softmax(torch.where(mask, logits, _MASK), dim=-1)
    out = _attn_einsum(policy, "bkgqs,bksd->bkgqd", probs, v, _score_tp(tp))
    return out.to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=None, q_chunk=1024,
                      kv_chunk=1024, policy: Optional[Policy] = None,
                      tp: Optional[TpSpec] = None):
    """Doubly chunked (q x kv) attention with an f32 online softmax
    (reference blocks.py:144-202), differentiated op by op (the "naive"
    ``attn_impl``).  q: [B,KV,G,Sq,d]; k,v: [B,KV,Sk,d].  The policy
    truncates q, k and v once at their sites and the output after; the
    contractions inside are f32 products, as in the reference.  The loop is
    ``flash_fwd_reference``'s, which is the reference's; its logsumexp is
    not used here."""
    q_chunk, kv_chunk = check_chunks(q.shape[3], k.shape[2], q_chunk,
                                     kv_chunk)
    if policy is not None:
        q, k, v = policy.split_qkv(q, k, v, tp)
    elif tp is not None:
        raise ValueError("a split attention runs through a policy")
    out, _ = flash_fwd_reference(q, k, v, causal=causal, window=window,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk)
    out = out.to(q.dtype)
    if policy is not None:
        out = policy.truncate(out, None if tp is None else tp.axis)
    return out


def decode_attention(q, k_cache, v_cache, valid, *,
                     policy: Optional[Policy] = None,
                     seq: Optional[shd.Split] = None):
    """One token's attention over a dense cache (reference
    blocks.py:205-222).  q: [B,KV,G,1,d]; caches [B,KV,Smax,d]; ``valid``:
    bool [Smax] of live cache slots, or [B, Smax] when the rows sit at
    their own positions (serving).  A sliding window is in ``valid`` (the
    caller's ring occupancy or window mask).  Both contractions go through
    ``policy.einsum``: on the payload path the batched payload GEMM with
    one query row a (slot, head) group.

    ``seq``: the caches (and ``valid``) are this rank's slice of the
    positions (``kv_seq`` over the model axis): the scores are split, the
    softmax's max and sum are combined over the axis, and P.V is a
    partial sum, all-reduced before its output truncation."""
    d = q.shape[-1]
    tp = None if seq is None else TpSpec(seq.axis, "full", "split", "split")
    logits = _attn_einsum(policy, "bkgqd,bksd->bkgqs", q, k_cache, tp) \
        / math.sqrt(d)
    vmask = valid[:, None, None, None, :] if valid.dim() == 2 else valid
    masked = torch.where(vmask, logits, _MASK)
    if seq is None:
        probs = torch.softmax(masked, dim=-1)
    else:
        top = collectives.all_reduce(
            masked.amax(dim=-1, keepdim=True).contiguous(), seq.axis,
            op="max")
        e = torch.exp(masked - top)
        probs = e / collectives.all_reduce(e.sum(dim=-1, keepdim=True),
                                           seq.axis)
    out = _attn_einsum(policy, "bkgqs,bksd->bkgqd", probs, v_cache,
                       None if tp is None else tp._replace(
                           a="split", out="partial"))
    return out.to(q.dtype)


def init_mlp(cfg: ArchConfig, gen: torch.Generator, d_in: int, d_ff: int,
             device=None) -> Dict[str, torch.Tensor]:
    """``w_gate``, ``w_down`` and, for a GLU activation only, ``w_up``."""
    std_in, std_ff = 1.0 / math.sqrt(d_in), 1.0 / math.sqrt(d_ff)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    p = {"w_gate": normal((d_in, d_ff), std_in),
         "w_down": normal((d_ff, d_in), std_ff)}
    if cfg.activation.endswith("_glu"):
        p["w_up"] = normal((d_in, d_ff), std_in)
    return p


def mlp_fwd(p, x, cfg: ArchConfig, pol: Policy,
            split: Optional[shd.Split] = None):
    """The MLP; ``split``: its hidden dim split over the model axis
    (``mlp_split``; the weights the rank's slices): ``w_gate`` / ``w_up``
    column-parallel, ``w_down`` row-parallel (its output a partial
    sum)."""
    glu = cfg.activation.endswith("_glu")
    with statsbank.scope("mlp"):
        hg = pol.dot(x, p["w_gate"].to(x.dtype), tp=col_tp(split))
        hl = (pol.dot(x, p["w_up"].to(x.dtype), tp=col_tp(split))
              if glu else None)
        h = activate(hg, hl, cfg.activation)
        return pol.dot(h, p["w_down"].to(x.dtype), tp=row_tp(split))



def init_moe(cfg: ArchConfig, gen: torch.Generator, device=None
             ) -> Dict[str, Any]:
    """Router [d, E], stacked experts [E, d, f] / [E, f, d], and the shared
    experts fused into one MLP of width ``n_shared * f`` (the reference's
    leaves and per-leaf std)."""
    m = cfg.moe
    d, f = cfg.d_model, m.expert_d_ff
    std_d, std_f = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    p = {"router": normal((d, m.n_experts), std_d),
         "we_gate": normal((m.n_experts, d, f), std_d),
         "we_down": normal((m.n_experts, f, d), std_f),
         "we_up": normal((m.n_experts, d, f), std_d)}
    if m.n_shared:
        p["shared"] = init_mlp(cfg, gen, d, m.n_shared * f, device)
    return p


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries along the last dim,
    ties to the lower index — ``jax.lax.top_k``'s order.  A stable
    descending sort gives it; ``torch.topk`` leaves the order of ties
    unspecified, and the capacity selection picks mostly among tied zero
    affinities whenever an expert has fewer tokens than its capacity."""
    vals, order = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k]


def route(router: torch.Tensor, x: torch.Tensor, m):
    """Token-choice top-k routing with per-expert capacity, as the
    reference's ``moe_fwd`` (x [T, d]: global, capacity rounded up to 128)
    and ``_moe_fwd_grouped`` (x [B, S, d]: per row, rounded up to 16) do it.
    Returns (probs [..., E], idx [..., k], w_ec [..., E, C], tok_idx [...,
    E, C]): each token's k experts, and each expert's C tokens (indices
    into the token axis) with their routing weights."""
    multiple = 128 if x.dim() == 2 else 16
    probs = torch.softmax(torch.matmul(x.float(), router), dim=-1)
    gate, idx = _top_k(probs, m.top_k)
    aff = torch.zeros(probs.shape, dtype=torch.float32,
                      device=x.device).scatter(-1, idx, gate)
    tokens = x.shape[-2]
    cap = int(math.ceil(tokens * m.top_k / m.n_experts * m.capacity_factor))
    cap = max(multiple, ((cap + multiple - 1) // multiple) * multiple)
    w_ec, tok_idx = _top_k(aff.transpose(-1, -2), min(cap, tokens))
    return probs, idx, w_ec, tok_idx


def _combine(oe: torch.Tensor, rows: torch.Tensor, n_tokens: int,
             dtype) -> torch.Tensor:
    """out[t] = the sum of the expert outputs ``oe [..., E, C, d]`` routed
    to token ``t`` (``rows [..., E, C]``), in ``dtype``.

    The reference's ``out.at[tok_idx].add(oe)`` adds in that dtype,
    rounding after each add, in expert-major order.  Here each expert's
    outputs are added in one ``index_add_`` in expert order: within an
    expert the capacity selection picks distinct tokens, so no two adds of
    a call meet and every token's sum is rounded in the reference's order.
    A single ``index_add_`` over all experts would add in an unspecified
    order on the card (atomics)."""
    d = oe.shape[-1]
    oe = oe.to(dtype)
    out = torch.zeros((n_tokens, d), dtype=dtype, device=oe.device)
    for e in range(rows.shape[-2]):
        out.index_add_(0, rows[..., e, :].reshape(-1),
                       oe[..., e, :, :].reshape(-1, d))
    return out


def _aux_loss(idx: torch.Tensor, probs: torch.Tensor, m) -> torch.Tensor:
    """Switch-style load balance: E * sum_e f_e * P_e * weight, f_e the
    share of routing choices, P_e the mean router probability."""
    lead = tuple(range(idx.dim() - 1))
    f_e = torch.nn.functional.one_hot(idx, m.n_experts).float().sum(
        dim=-2).mean(dim=lead)
    p_e = probs.mean(dim=lead)
    return m.n_experts * (f_e * p_e).sum() * m.router_aux_weight


def _experts(p, xe: torch.Tensor, w_ec: torch.Tensor, cfg: ArchConfig,
             pol: Policy, lead: str = "") -> torch.Tensor:
    """The routed experts' SiLU-GLU on their dispatched tokens ``xe [lead,
    E, C, d]``, each output scaled by its routing weight: three expert
    einsums on the batched payload GEMM (``lead`` "b": the weights are
    broadcast over the batch rows)."""
    hg = pol.einsum(f"{lead}ecd,edf->{lead}ecf", xe,
                    p["we_gate"].to(xe.dtype))
    hl = pol.einsum(f"{lead}ecd,edf->{lead}ecf", xe, p["we_up"].to(xe.dtype))
    h = activate(hg, hl, cfg.activation)
    oe = pol.einsum(f"{lead}ecf,efd->{lead}ecd", h,
                    p["we_down"].to(xe.dtype))
    return oe * w_ec[..., None].to(oe.dtype)


def moe_fwd(p, x: torch.Tensor, cfg: ArchConfig, pol: Policy):
    """Gather-based capacity dispatch (reference blocks.py:273-324):
    token-choice top-k routing, then each expert takes its top-C tokens by
    routing weight (C = T*k/E * capacity_factor, rounded up to 128).
    Dropped tokens keep only the shared-expert and residual paths.  The
    router stays an f32 ``torch.matmul`` outside any kernel, as the
    reference leaves it.  Returns (out [B, S, d], aux)."""
    m = cfg.moe
    if m.routing == "grouped":
        return _moe_fwd_grouped(p, x, cfg, pol)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    probs, idx, w_ec, tok_idx = route(p["router"], xt, m)
    xe = xt[tok_idx.reshape(-1)].reshape(tok_idx.shape + (d,))
    out = _combine(_experts(p, xe, w_ec, cfg, pol), tok_idx, t, x.dtype)
    if m.n_shared:
        out = out + mlp_fwd(p["shared"], xt, cfg, pol)
    return out.reshape(b, s, d), _aux_loss(idx, probs, m)


def _moe_fwd_grouped(p, x: torch.Tensor, cfg: ArchConfig, pol: Policy):
    """Grouped (per batch row) routing (reference blocks.py:326-376): each
    row routes its own tokens with a per-(row, expert) capacity rounded up
    to 16; the expert einsums broadcast the stored weights over the rows
    (``becd,edf->becf``: B slice ``g % E`` of the combined batch)."""
    m = cfg.moe
    b, s, d = x.shape
    probs, idx, w_ec, tok_idx = route(p["router"], x, m)
    rows = torch.arange(b, device=x.device)[:, None, None]
    xe = x[rows, tok_idx]                                      # [B, E, C, d]
    oe = _experts(p, xe, w_ec, cfg, pol, lead="b")
    out = _combine(oe, rows * s + tok_idx, b * s, x.dtype).reshape(b, s, d)
    if m.n_shared:
        out = out + mlp_fwd(p["shared"], x, cfg, pol)
    return out, _aux_loss(idx, probs, m)


def init_attn_block(cfg: ArchConfig, gen: torch.Generator, device=None,
                    block_type: str = "dense") -> Dict[str, Any]:
    """Same leaves and per-leaf std as the reference's init_attn_block:
    ``moe`` blocks hold a ``moe`` subtree, ``dense_first`` blocks an MLP of
    width ``moe.dense_d_ff``, the other types an MLP of width ``d_ff``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.kv_heads
    std, std_o = 1.0 / math.sqrt(d), 1.0 / math.sqrt(h * hd)

    def normal(shape, s):
        return torch.randn(shape, generator=gen, device=device) * s

    p = {
        "ln1": init_norm(cfg, d, device),
        "wq": normal((d, h * hd), std),
        "wk": normal((d, kv * hd), std),
        "wv": normal((d, kv * hd), std),
        "wo": normal((h * hd, d), std_o),
        "ln2": init_norm(cfg, d, device),
    }
    if block_type == "moe":
        p["moe"] = init_moe(cfg, gen, device)
    elif block_type in ATTN_BLOCK_TYPES:
        d_ff = cfg.d_ff
        if block_type == "dense_first" and cfg.moe:
            d_ff = cfg.moe.dense_d_ff or cfg.d_ff
        p["mlp"] = init_mlp(cfg, gen, d, d_ff, device)
    else:
        raise NotImplementedError(f"block type {block_type!r} is not ported")
    return p


def attn_block_apply(p, x: torch.Tensor, cfg: ArchConfig, pol: Policy,
                     positions: torch.Tensor, cache, cache_index, mode: str,
                     block_type: str = "dense",
                     cache_fmt: Optional[str] = None,
                     window: Optional[int] = None):
    """One attention block.  ``mode="train"`` attends over the sequence and
    keeps no cache; ``mode="prefill"`` also fills the dense cache ``cache``
    ({"k","v"} [B, KV, Smax, hd], written in place) with K/V (truncated at
    the kv_cache sites under a session; with ``window``, the last Smax
    positions); ``mode="decode"`` writes one token into and attends over
    the paged payload cache (serving/paged_cache.py), or the dense cache
    (``cache_index`` a scalar or per-slot [B] positions; with ``window``
    the cache is a ring buffer when Smax <= window).  A ``moe`` block runs
    its MoE under the ``moe`` StatsBank scope.  An ``encoder`` block of an
    encoder-decoder attends without the causal mask (the reference's rule,
    in every attention branch).  A ``local`` block attends within
    ``cfg.window`` keys whatever ``window`` says (the reference's rule);
    the other types take ``window`` as given (None: global).  Returns (x,
    cache, aux): aux is the MoE's load-balance loss, 0 for the other block
    types.

    Under the rules on a bound mesh (``parallel.sharding``) a
    ``TP_BLOCK_TYPES`` block computes its part of the model axis
    (``attn_split``, ``mlp_split``): q/k/v column-parallel by query / K/V
    heads and ``wo`` row-parallel; the MLP as ``mlp_fwd``; a dense decode
    cache split on ``kv_seq`` holds this rank's positions
    (``_dense_decode``, and the prefill stores its slice).  The weights
    are the rank's slices (``parallel.sharding.Placement``)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.kv_heads
    if block_type == "local":
        window = cfg.window
    sp = attn_split(cfg, block_type)
    heads = None if sp is None else sp.heads
    kv = None if sp is None else sp.kv
    hl = h if heads is None else heads.part(h)
    kvl = kvh if kv is None else kv.part(kvh)

    xn = apply_norm(p["ln1"], x, cfg)
    with statsbank.scope("attn"):
        q = pol.dot(xn, p["wq"].to(x.dtype), tp=col_tp(heads)).reshape(
            b, s, hl, hd).transpose(1, 2)
        k = pol.dot(xn, p["wk"].to(x.dtype), tp=col_tp(kv)).reshape(
            b, s, kvl, hd).transpose(1, 2)
        v = pol.dot(xn, p["wv"].to(x.dtype), tp=col_tp(kv)).reshape(
            b, s, kvl, hd).transpose(1, 2)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # the attention's split: q's heads; K/V split with them, or whole with
    # the rank's one K/V head picked after their truncation
    a_tp = None if sp is None else TpSpec(
        heads.axis, "split", "full" if kv is None else "split", "split",
        sp.pick)
    qg = _grouped(q, 1 if sp is not None and kv is None else kvl)

    if mode == "decode" and cache is not None and "kp" in cache:
        from repro_torch.serving import paged_cache as _paged
        if s != 1:
            raise ValueError("decode runs one token against a paged cache")
        attn, cache = _paged.update_and_attend(
            qg, k, v, cache, cache_index, policy=pol, cache_fmt=cache_fmt)
    elif mode == "decode":
        if s != 1 or cache is None:
            raise ValueError("decode runs one token against a cache")
        if sp is not None:
            raise NotImplementedError("decode with split heads: the decode "
                                      "rules split kv_seq, not heads")
        attn = _dense_decode(qg, k, v, cache, cache_index, pol, window,
                             _seq_split(block_type, cache))
    elif mode in ("train", "prefill"):
        causal = not (cfg.enc_dec and block_type == "encoder")
        if s > LONG_SEQ:
            if cfg.attn_impl == "flash":
                attn = pol.flash_attention(qg, k, v, causal=causal,
                                           window=window,
                                           tp=a_tp).to(qg.dtype)
            else:
                attn = chunked_attention(qg, k, v, causal=causal,
                                         window=window, policy=pol,
                                         tp=a_tp)
        else:
            attn = full_attention(qg, k, v, causal=causal, window=window,
                                  policy=pol, tp=a_tp)
        if mode == "prefill" and cache is not None:
            if sp is not None:
                raise NotImplementedError("a prefill cache with split "
                                          "heads: the decode rules keep "
                                          "heads whole")
            k_store, v_store = _kv_store(k, v, pol)
            _prefill_store(cache, k_store, v_store, s, window,
                           _seq_split(block_type, cache))
    else:
        raise ValueError(f"mode {mode!r} is not ported "
                         f"(train/prefill/decode)")

    attn = attn.reshape(b, hl, s, hd).transpose(1, 2).reshape(b, s, hl * hd)
    with statsbank.scope("attn"):
        x = x + pol.dot(attn, p["wo"].to(x.dtype), tp=row_tp(heads))
    xn2 = apply_norm(p["ln2"], x, cfg)
    if block_type == "moe":
        with statsbank.scope("moe"):
            y, aux = moe_fwd(p["moe"], xn2, cfg, pol)
    else:
        y = mlp_fwd(p["mlp"], xn2, cfg, pol,
                    mlp_split(cfg, block_type, block_d_ff(cfg, block_type)))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, cache, aux


def block_d_ff(cfg: ArchConfig, block_type: str) -> int:
    """The MLP width of a non-MoE attention block (``init_attn_block``'s
    rule)."""
    if block_type == "dense_first" and cfg.moe:
        return cfg.moe.dense_d_ff or cfg.d_ff
    return cfg.d_ff


def _seq_split(block_type: str, cache) -> Optional[shd.Split]:
    """The ``kv_seq`` split of a ``TP_BLOCK_TYPES`` block's dense cache
    over the model axis (the rank's cache holds its share of the
    positions), or None."""
    if block_type not in TP_BLOCK_TYPES or cache is None:
        return None
    return shd.split("kv_seq",
                     cache["k"].shape[2] * shd.axis_size("kv_seq"))


def _prefill_store(cache, k_store, v_store, s: int, window,
                   seq: Optional[shd.Split]) -> None:
    """Write a prefill's K/V into the dense cache in place: the whole
    cache's first ``keep`` positions hold the last ``keep`` tokens (all
    ``s`` without a window), the rest zeros; with ``seq`` the cache is
    this rank's slice of the positions and takes its part."""
    sl = cache["k"].shape[2]
    lo = 0 if seq is None else seq.coord * sl
    smax = sl if seq is None else sl * seq.size
    keep = min(smax, s) if window else s
    n = max(0, min(keep - lo, sl))
    for key, val in (("k", k_store), ("v", v_store)):
        if n:
            cache[key][:, :, :n] = val[:, :, s - keep + lo:s - keep + lo + n]
        cache[key][:, :, n:] = 0.0


def _kv_store(k, v, pol: Policy):
    """The K/V a dense cache stores: under a session truncated at the
    block's kv_cache/t{0,1} sites, so the cache holds grid-snapped values
    (a payload re-encode is lossless) and calibration learns their stats;
    without one, K/V as computed (reference blocks.py:439-447, 502-511)."""
    if statsbank.current_session() is None:
        return k, v
    with statsbank.scope("kv_cache"):
        return pol.truncate(k), pol.truncate(v)


def _dense_decode(qg, k, v, cache, cache_index, pol: Policy,
                  window: Optional[int], seq: Optional[shd.Split] = None):
    """The dense-cache decode of reference blocks.py:431-481: write the
    token's (kv_cache-site truncated) K/V at its slot, in place, then
    ``decode_attention`` over the cache.  ``cache_index``: a scalar
    position for every row, or [B] per-slot positions.  With ``window``
    and Smax <= window the cache is a ring buffer (slot = position mod
    Smax, every written slot live); otherwise the slot is the position and
    the window masks older keys.

    ``seq``: the cache is this rank's slice of the positions (``kv_seq``
    over the model axis; Smax the whole length): only the rank whose
    slice holds the slot writes, and the attention combines over the
    axis (``decode_attention``)."""
    b = qg.shape[0]
    sl = cache["k"].shape[2]
    lo = 0 if seq is None else seq.coord * sl
    smax = sl if seq is None else sl * seq.size
    kpos = torch.arange(lo, lo + sl, device=qg.device)
    ci = torch.as_tensor(cache_index, device=qg.device).long()
    ring = bool(window) and smax <= window
    k_store, v_store = _kv_store(k, v, pol)
    if ci.dim() == 1:
        if ring:
            slot = ci % smax
            valid = kpos[None, :] < torch.clamp(ci + 1, max=smax)[:, None]
        else:
            slot = ci
            valid = kpos[None, :] <= ci[:, None]
            if window:
                valid &= kpos[None, :] > ci[:, None] - window
        bi = torch.arange(b, device=qg.device)
        if seq is None:
            for key, val in (("k", k_store), ("v", v_store)):
                cache[key][bi, :, slot] = val[:, :, 0].to(cache[key].dtype)
        else:
            # rows whose slot is in this rank's slice write; the others
            # rewrite what they read
            mine = (slot >= lo) & (slot < lo + sl)
            local = torch.clamp(slot - lo, 0, sl - 1)
            for key, val in (("k", k_store), ("v", v_store)):
                old = cache[key][bi, :, local]
                cache[key][bi, :, local] = torch.where(
                    mine[:, None, None], val[:, :, 0].to(old.dtype), old)
    else:
        c = int(ci)
        if ring:
            slot = c % smax
            valid = kpos < min(c + 1, smax)
        else:
            slot = c
            valid = kpos <= c
            if window:
                valid &= kpos > c - window
        slot = min(max(slot, 0), smax - 1)    # dynamic_update_slice clamps
        if lo <= slot < lo + sl:
            for key, val in (("k", k_store), ("v", v_store)):
                cache[key][:, :, slot - lo:slot - lo + 1] = val.to(
                    cache[key].dtype)
    return decode_attention(qg, cache["k"], cache["v"], valid, policy=pol,
                            seq=seq)


# =========================================================================
# Mamba-1 (falcon-mamba)
# =========================================================================

def _silu_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` on f32, as XLA lowers it: x * 1 / (1 + exp(-x))."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _causal_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x [B, S, C], kernel [K, C], in f32 (the
    reference's ``conv_general_dilated`` over a left pad of K-1 zeros:
    out[s] = sum_k x[s - K + 1 + k] * kernel[k]), then ``+ bias`` and back
    to x's dtype.  The K products are summed in k order with plain torch
    ops, as the decode step sums its window."""
    k, s = kernel.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x.float(), (0, 0, k - 1, 0))
    out = xp[:, 0:s] * kernel[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * kernel[i]
    return (out + bias).to(x.dtype)


def init_mamba1(cfg: ArchConfig, gen: torch.Generator, device=None
                ) -> Dict[str, torch.Tensor]:
    """The reference's leaves, shapes and per-leaf std: A = -exp(a_log)
    with a_log = log(1..n) per channel, dt's bias softplus^-1(0.01), D =
    1."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    dtr = s.dt_rank or d // 16

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    b_dt = math.log(math.expm1(0.01))
    return {
        "ln": init_norm(cfg, d, device),
        "w_in": normal((d, 2 * di), 1.0 / math.sqrt(d)),
        "conv_w": normal((s.conv_kernel, di), 0.1),
        "conv_b": torch.zeros((di,), dtype=torch.float32, device=device),
        "w_x": normal((di, dtr + 2 * s.state), 1.0 / math.sqrt(di)),
        "w_dt": normal((dtr, di), 1.0 / math.sqrt(dtr)),
        "b_dt": torch.full((di,), b_dt, dtype=torch.float32, device=device),
        "a_log": torch.log(torch.arange(
            1, s.state + 1, dtype=torch.float32, device=device)
        ).repeat(di, 1),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=device),
        "w_out": normal((di, d), 1.0 / math.sqrt(di)),
    }


def _check_ssm_mode(mode: str, cache) -> None:
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r} is not ported "
                         f"(train/prefill/decode)")
    if mode == "train" and cache is not None:
        raise ValueError("an SSM block trains without a cache")


def _conv_window(cache_conv: torch.Tensor, new: torch.Tensor,
                 kernel: torch.Tensor, bias: torch.Tensor):
    """The decode step's conv: the cached K-1 inputs and the new one (in
    their promoted dtype, as the reference's concatenate promotes), summed
    in f32 in k order, plus the bias -> (conv f32 [B, C], new window
    [B, K-1, C])."""
    wdt = torch.promote_types(cache_conv.dtype, new.dtype)
    window = torch.cat([cache_conv.to(wdt), new.to(wdt)], dim=1)
    wf = window.float()
    out = wf[:, 0] * kernel[0]
    for i in range(1, kernel.shape[0]):
        out = out + wf[:, i] * kernel[i]
    return out + bias, window[:, 1:]


def mamba1_apply(p, x: torch.Tensor, cfg: ArchConfig, pol: Policy, cache,
                 mode: str):
    """One Mamba-1 block (reference blocks.py:578-652).  ``mode="train"``
    runs the causal conv and the selective scan with its gradient
    (``SelectiveScanFn``: the scan kernel and its backward kernel);
    ``mode="prefill"`` runs the scan kernel over the sequence and, given a
    cache, writes its last K-1 conv inputs and the final state into it in
    place; ``mode="decode"`` advances one token from the cache (updated in
    place).  The three GEMMs go through the policy; dt's projection is an
    f32 ``torch.matmul`` and the conv and the decode step plain f32 ops, as
    the reference computes them outside the policy.  Returns (x, cache, aux
    = 0)."""
    _check_ssm_mode(mode, cache)
    s_cfg = cfg.ssm
    b, s, d = x.shape
    di = s_cfg.expand * d
    dtr = s_cfg.dt_rank or d // 16
    n = s_cfg.state
    kk = s_cfg.conv_kernel

    xn = apply_norm(p["ln"], x, cfg)
    xz = pol.dot(xn, p["w_in"].to(x.dtype))                  # [B, S, 2di]
    xpart, z = xz[..., :di], xz[..., di:]

    if mode == "decode":
        if cache is None or s != 1:
            raise ValueError("mamba1 decode runs one token against a cache")
        xc, new_conv = _conv_window(cache["conv"], xpart, p["conv_w"],
                                    p["conv_b"])
        xc = _silu_f32(xc).to(x.dtype)[:, None]                # [B, 1, di]
    else:
        if cache is not None and s < kk - 1:
            raise ValueError(f"a prefill that fills the cache needs at least "
                             f"{kk - 1} tokens, got {s}")
        xc = _silu_f32(_causal_conv1d(xpart, p["conv_w"], p["conv_b"])
                       .float()).to(x.dtype)
        new_conv = None if cache is None else xpart[:, s - (kk - 1):]

    xdb = pol.dot(xc, p["w_x"].to(x.dtype)).float()
    dt_r, bmat, cmat = torch.split(xdb, [dtr, n, n], dim=-1)   # [B, S, *]
    dt_lin = torch.matmul(dt_r, p["w_dt"]) + p["b_dt"]
    dt = torch.logaddexp(dt_lin, torch.zeros_like(dt_lin))     # softplus
    a = -torch.exp(p["a_log"])                                 # [di, n]
    xcf = xc.float()

    if mode == "decode":
        h0 = cache["ssm"].float()                              # [B, di, n]
        da = torch.exp(dt[:, 0, :, None] * a)
        hn = (h0 * da + (dt[:, 0, :, None] * bmat[:, 0, None, :])
              * xcf[:, 0, :, None])
        y = torch.einsum("bdn,bn->bd", hn, cmat[:, 0])[:, None]
        y = y + p["d_skip"] * xcf
    elif mode == "train":
        # the kernel adds D x inside the scan (the reference adds the same
        # f32 term after it): only the order of the sums differs
        y = scan.SelectiveScanFn.apply(xcf, dt, bmat, cmat, a, p["d_skip"])
    else:
        y, hn = scan.selective_scan(xcf.contiguous(), dt.contiguous(),
                                    bmat.contiguous(), cmat.contiguous(),
                                    a.contiguous(), p["d_skip"].contiguous())
    y = y.to(x.dtype)
    y = y * (z * (1.0 / (1.0 + torch.exp(-z))))   # silu(z), rounded per op
    out = pol.dot(y, p["w_out"].to(x.dtype))
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(hn)
    return x + out, cache, torch.zeros((), dtype=torch.float32,
                                       device=x.device)


# =========================================================================
# Mamba-2 (zamba2): multi-head SSD with a scalar decay a head
# =========================================================================

def init_mamba2(cfg: ArchConfig, gen: torch.Generator, device=None
                ) -> Dict[str, torch.Tensor]:
    """The reference's leaves, shapes and per-leaf std: w_in's outputs
    [x (di) | z (di) | B (n) | C (n) | dt (nh)] by its comment, read as
    [x|B|C (di + 2n, conv'd) | z | dt] by the block; A = -exp(a_log) with
    a_log = log(linspace(1, 16, nh)), dt's bias softplus^-1(0.01), D = 1
    per head, the gated norm's scale 1."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = di // s.head_dim

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln": init_norm(cfg, d, device),
        "w_in": normal((d, 2 * di + 2 * s.state + nh), 1.0 / math.sqrt(d)),
        "conv_w": normal((s.conv_kernel, di + 2 * s.state), 0.1),
        "conv_b": torch.zeros((di + 2 * s.state,), **f32),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.full((nh,), math.log(math.expm1(0.01)), **f32),
        "d_skip": torch.ones((nh,), **f32),
        "norm_scale": torch.ones((di,), **f32),
        "w_out": normal((di, d), 1.0 / math.sqrt(di)),
    }


def mamba2_apply(p, x: torch.Tensor, cfg: ArchConfig, pol: Policy, cache,
                 mode: str):
    """One Mamba-2 block (reference blocks.py:681-747): the in projection
    through the policy, the causal conv over [x | B | C] (di + 2n channels)
    and SiLU in f32, dt = softplus(dt_in + dt_bias) per head, the per-head
    selective scan with D x inside it (training through
    ``SelectiveScanFn``, prefill through the scan kernel, whatever
    ``cfg.ssm_impl`` names), then the gated RMSNorm in f32 (y silu(z),
    times rsqrt(mean(y^2) + 1e-6) and the scale) and the out projection
    through the policy.  The cache is {conv [B, K-1, di + 2n], ssm [B, nh,
    hd, n] f32}, written in place at prefill and decode; decode is the
    reference's single step in plain torch ops.  Returns (x, cache, aux =
    0)."""
    _check_ssm_mode(mode, cache)
    s_cfg = cfg.ssm
    b, s, d = x.shape
    di = s_cfg.expand * d
    n = s_cfg.state
    hd = s_cfg.head_dim
    nh = di // hd
    kk = s_cfg.conv_kernel

    xn = apply_norm(p["ln"], x, cfg)
    proj = pol.dot(xn, p["w_in"].to(x.dtype))
    # w_in output layout: [ x|B|C (conv'd, di+2n) | z (di) | dt (nh) ]
    xbc = proj[..., :di + 2 * n]
    z = proj[..., di + 2 * n:2 * di + 2 * n]
    dt_in = proj[..., 2 * di + 2 * n:]

    if mode == "decode":
        if cache is None or s != 1:
            raise ValueError("mamba2 decode runs one token against a cache")
        conv, new_conv = _conv_window(cache["conv"], xbc, p["conv_w"],
                                      p["conv_b"])
        conv = _silu_f32(conv)[:, None]                     # [B, 1, di+2n]
    else:
        if cache is not None and s < kk - 1:
            raise ValueError(f"a prefill that fills the cache needs at least "
                             f"{kk - 1} tokens, got {s}")
        conv = _silu_f32(_causal_conv1d(xbc, p["conv_w"], p["conv_b"])
                         .float())
        new_conv = None if cache is None else xbc[:, s - (kk - 1):]

    xpart = conv[..., :di]                                  # [B, S, di] f32
    bmat = conv[..., di:di + n]                             # [B, S, n]
    cmat = conv[..., di + n:]                               # [B, S, n]
    dt_lin = dt_in.float() + p["dt_bias"]
    dt = torch.logaddexp(dt_lin, torch.zeros_like(dt_lin))  # softplus, [B,S,nh]
    a = -torch.exp(p["a_log"])                              # [nh]

    if mode == "decode":
        h0 = cache["ssm"].float()                           # [B, nh, hd, n]
        xh = xpart[:, 0].reshape(b, nh, hd)
        da = torch.exp(dt[:, 0] * a)                        # [B, nh]
        upd = (dt[:, 0, :, None] * xh)[..., None] * bmat[:, 0, None, None, :]
        hn = h0 * da[:, :, None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", hn, cmat[:, 0])
        y = (y + p["d_skip"][:, None] * xh).reshape(b, 1, di)
    elif mode == "train":
        y = scan.SelectiveScanFn.apply(xpart, dt, bmat, cmat, a,
                                       p["d_skip"])
    else:
        y, hn = scan.selective_scan(xpart.contiguous(), dt.contiguous(),
                                    bmat.contiguous(), cmat.contiguous(),
                                    a.contiguous(), p["d_skip"].contiguous())
        hn = hn.view(b, nh, hd, n)
    # gated RMSNorm then output proj
    y = y * _silu_f32(z.float())
    y = y * torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + 1e-6) \
        * p["norm_scale"]
    out = pol.dot(y.to(x.dtype), p["w_out"].to(x.dtype))
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(hn)
    return x + out, cache, torch.zeros((), dtype=torch.float32,
                                       device=x.device)


# =========================================================================
# Uniform dispatch + caches
# =========================================================================

ATTN_BLOCK_TYPES = ("dense", "local", "moe", "attn", "dense_first",
                    "encoder")


def init_block(block_type: str, cfg: ArchConfig, gen: torch.Generator,
               device=None) -> Dict[str, Any]:
    if block_type in ATTN_BLOCK_TYPES:
        return init_attn_block(cfg, gen, device, block_type)
    if block_type == "mamba1":
        return init_mamba1(cfg, gen, device)
    if block_type == "mamba2":
        return init_mamba2(cfg, gen, device)
    raise NotImplementedError(f"block type {block_type!r} is not ported")


def block_apply(block_type: str, params, x: torch.Tensor, cfg: ArchConfig,
                pol: Policy, positions, cache=None, cache_index=None,
                mode: str = "train", cache_fmt: Optional[str] = None):
    if block_type in ATTN_BLOCK_TYPES:
        return attn_block_apply(params, x, cfg, pol, positions, cache,
                                cache_index, mode, block_type, cache_fmt)
    if block_type == "mamba1":
        return mamba1_apply(params, x, cfg, pol, cache, mode)
    if block_type == "mamba2":
        return mamba2_apply(params, x, cfg, pol, cache, mode)
    raise NotImplementedError(f"block type {block_type!r} is not ported")


def init_cache(block_type: str, cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """One layer's dense cache: attention {k, v} [B, KV, max_len, hd] in
    ``dtype`` (a ``local`` block's a ring of ``min(max_len, window)``
    positions, reference blocks.py:835-837); mamba1 {conv [B, K-1, di] in
    ``dtype``, ssm [B, di, n] in f32}; mamba2 {conv [B, K-1, di + 2n] in
    ``dtype``, ssm [B, nh, hd, n] in f32}."""
    if block_type in ATTN_BLOCK_TYPES:
        slots = max_len
        if block_type == "local":
            slots = min(max_len, cfg.window or max_len)
        shape = (batch, cfg.kv_heads, slots, cfg.resolved_head_dim)
        return {key: torch.zeros(shape, dtype=dtype, device=device)
                for key in ("k", "v")}
    if block_type == "mamba1":
        s = cfg.ssm
        di = s.expand * cfg.d_model
        return {"conv": torch.zeros((batch, s.conv_kernel - 1, di),
                                    dtype=dtype, device=device),
                "ssm": torch.zeros((batch, di, s.state), dtype=torch.float32,
                                   device=device)}
    if block_type == "mamba2":
        s = cfg.ssm
        di = s.expand * cfg.d_model
        return {"conv": torch.zeros((batch, s.conv_kernel - 1,
                                     di + 2 * s.state), dtype=dtype,
                                    device=device),
                "ssm": torch.zeros((batch, di // s.head_dim, s.head_dim,
                                    s.state), dtype=torch.float32,
                                   device=device)}
    raise NotImplementedError(f"block type {block_type!r} is not ported")
