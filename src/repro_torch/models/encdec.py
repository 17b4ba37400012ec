"""Encoder-decoder transformer (port of ``repro.models.encdec``: the
whisper-medium backbone and the paper's transformer_tiny).

The modality frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings [B, S_frames, d_model] (whisper's audio
stub) or token ids [B, S] (transformer_tiny, looked up in ``embed``
without a truncation, as the reference does).  Decoder blocks are causal
self-attention (rope, a dense cache in serving) + cross-attention over
the encoder output (K/V computed once by :func:`cross_kv`, no rope) + the
MLP.

Params keep the reference's tree: ``embed`` [V, d], ``head`` [d, V],
``enc_norm``, ``dec_norm``, and the [L]-stacked layers ``encoder`` (the
``encoder`` blocks of ``models/blocks.py``: non-causal) and ``decoder``,
so ``convert.params_from_jax`` carries ``init_encdec``'s tree unchanged.
The reference's ``lax.scan`` over the layers is a Python loop over the
unbound stacked leaves, as in ``models/transformer.py``; ``cfg.remat``
rematerializes each encoder layer, and each decoder layer in training,
with ``torch.utils.checkpoint`` under the forward's StatsBank session.

StatsBank sites: the segments ``enc`` (the encoder blocks, their
projections under the blocks' ``attn`` scope), ``xkv`` (each decoder
layer's cross K/V projections) and ``dec`` (the decoder blocks: their
projections sit at the segment root, with no ``attn`` scope, as in the
reference), and the ``head`` scope; so one bank drives both packages with
the same keys.  Serving (:func:`serve_prefill`, :func:`serve_decode`) runs
the decoder layers outside any segment, as the reference's cached scan
does: under a session every layer visits the same unsegmented sites
(``statsbank.shared_sites``), one entry shared by all decoder layers, so
a bank discovered on the cached decode graph drives both packages and a
bank of the training graph (keys under ``dec/``) raises ``KeyError``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import statsbank
from repro_torch.core.policy import Policy
from repro_torch.models import blocks
from repro_torch.models.blocks import (LONG_SEQ, _grouped, apply_norm,
                                       chunked_attention, decode_attention,
                                       full_attention, init_mlp, init_norm,
                                       mlp_fwd, rope)
from repro_torch.models.transformer import (DTYPES, _stack_layers, _unstack,
                                            remat_call)


# ---------------------------------------------------------------------------
# decoder block (self + cross + mlp)
# ---------------------------------------------------------------------------

def init_dec_block(cfg: ArchConfig, gen: torch.Generator, device=None
                   ) -> Dict[str, Any]:
    """The reference's leaves and per-leaf std: ``ln1``, ``self`` {wq, wk,
    wv, wo}, ``ln_x``, ``cross`` {wq, wk, wv, wo}, ``ln2``, ``mlp``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.kv_heads
    std, std_o = 1.0 / math.sqrt(d), 1.0 / math.sqrt(h * hd)

    def normal(shape, s):
        return torch.randn(shape, generator=gen, device=device) * s

    def qkvo():
        return {"wq": normal((d, h * hd), std), "wk": normal((d, kv * hd), std),
                "wv": normal((d, kv * hd), std),
                "wo": normal((h * hd, d), std_o)}

    return {"ln1": init_norm(cfg, d, device), "self": qkvo(),
            "ln_x": init_norm(cfg, d, device), "cross": qkvo(),
            "ln2": init_norm(cfg, d, device),
            "mlp": init_mlp(cfg, gen, d, cfg.d_ff, device)}


def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """[B, S, n * hd] -> [B, n, S, hd]."""
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)


def _merge(attn: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """[B, KV, G, S, hd] -> [B, S, H * hd]."""
    hd = attn.shape[-1]
    return attn.reshape(b, -1, s, hd).transpose(1, 2).reshape(b, s, -1)


def _proj_qkv(p, xq, xkv, cfg: ArchConfig, pol: Policy, positions_q,
              positions_k, use_rope: bool = True):
    """(grouped q [B, KV, G, Sq, hd], k, v [B, KV, Sk, hd])."""
    hd, h, kvh = cfg.resolved_head_dim, cfg.n_heads, cfg.kv_heads
    q = _heads(pol.dot(xq, p["wq"].to(xq.dtype)), h, hd)
    k = _heads(pol.dot(xkv, p["wk"].to(xq.dtype)), kvh, hd)
    v = _heads(pol.dot(xkv, p["wv"].to(xq.dtype)), kvh, hd)
    if use_rope:
        q = rope(q, positions_q, cfg.rope_theta)
        k = rope(k, positions_k, cfg.rope_theta)
    return _grouped(q, kvh), k, v


def dec_block_apply(p, x: torch.Tensor, enc_kv, cfg: ArchConfig,
                    pol: Policy, positions, cache, cache_index, mode: str):
    """One decoder layer.  ``enc_kv``: {"k", "v"} [B, KV, S_enc, hd], the
    layer's cross K/V.  ``mode="decode"`` writes the token's K/V at
    ``cache_index`` of ``cache`` ({"k","v"} [B, KV, Smax, hd], in place;
    the index clamps as ``dynamic_update_slice`` does) and attends over
    the slots up to it (``decode_attention``); ``"prefill"`` with a cache
    fills it from position 0 and zeroes the rest.  Returns (x, cache)."""
    b, s, _ = x.shape

    # --- causal self-attention ---------------------------------------------
    xn = apply_norm(p["ln1"], x, cfg)
    qg, k, v = _proj_qkv(p["self"], xn, xn, cfg, pol, positions, positions)
    if mode == "decode":
        smax = cache["k"].shape[2]
        ci = int(cache_index)
        slot = min(max(ci, 0), smax - s)
        for key, val in (("k", k), ("v", v)):
            cache[key][:, :, slot:slot + s] = val.to(cache[key].dtype)
        valid = torch.arange(smax, device=x.device) <= ci
        attn = decode_attention(qg, cache["k"], cache["v"], valid,
                                policy=pol)
    else:
        attn = (full_attention(qg, k, v, causal=True, policy=pol)
                if s <= LONG_SEQ else
                chunked_attention(qg, k, v, causal=True, policy=pol))
        if mode == "prefill" and cache is not None:
            for key, val in (("k", k), ("v", v)):
                cache[key][:, :, :s] = val.to(cache[key].dtype)
                cache[key][:, :, s:] = 0.0
    x = x + pol.dot(_merge(attn, b, s), p["self"]["wo"].to(x.dtype))

    # --- cross-attention ----------------------------------------------------
    xn = apply_norm(p["ln_x"], x, cfg)
    q = _heads(pol.dot(xn, p["cross"]["wq"].to(x.dtype)), cfg.n_heads,
               cfg.resolved_head_dim)
    qg = _grouped(q, cfg.kv_heads)
    ek, ev = enc_kv["k"].to(x.dtype), enc_kv["v"].to(x.dtype)
    attn = (full_attention(qg, ek, ev, causal=False, policy=pol)
            if ek.shape[2] <= LONG_SEQ else
            chunked_attention(qg, ek, ev, causal=False, policy=pol))
    x = x + pol.dot(_merge(attn, b, s), p["cross"]["wo"].to(x.dtype))

    # --- mlp ----------------------------------------------------------------
    x = x + mlp_fwd(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg, pol)
    return x, cache


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init_encdec(cfg: ArchConfig, seed: int = 0, device=None
                ) -> Dict[str, Any]:
    """Random params from a seeded ``torch.Generator`` on ``device`` (the
    reference's leaves and per-leaf std; JAX draws other numbers, see
    ``convert.params_from_jax``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": torch.randn((cfg.vocab, d), generator=gen, device=dev) * 0.02,
        "head": torch.randn((d, cfg.vocab), generator=gen, device=dev)
        / math.sqrt(d),
        "enc_norm": init_norm(cfg, d, dev),
        "dec_norm": init_norm(cfg, d, dev),
    }
    params["encoder"] = _stack_layers(
        lambda: blocks.init_block("encoder", cfg, gen, dev), cfg.n_enc_layers)
    params["decoder"] = _stack_layers(
        lambda: init_dec_block(cfg, gen, dev), cfg.n_layers)
    return params


def _n_layers(stacked) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def encode(params, enc_inputs: torch.Tensor, cfg: ArchConfig, pol: Policy
           ) -> torch.Tensor:
    """``enc_inputs``: [B, S_enc, d_model] frame embeddings (audio stub) or
    [B, S_enc] token ids -> the normed encoder output [B, S_enc, d] in the
    activation dtype."""
    act = DTYPES[cfg.activation_dtype]
    x = (params["embed"][enc_inputs.long()] if enc_inputs.dim() == 2
         else enc_inputs).to(act)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    n_enc = _n_layers(params["encoder"])
    statsbank.segment_sites("enc", n_enc)
    for li, layer_p in enumerate(_unstack(params["encoder"], n_enc)):
        def run(x, layer_p=layer_p, li=li):
            with statsbank.segment_ctx("enc", li):
                y, _, _ = blocks.block_apply("encoder", layer_p, x, cfg, pol,
                                             positions, None, 0, "train")
            return y
        x = remat_call(run, cfg.remat, x)
    return apply_norm(params["enc_norm"], x, cfg)


def cross_kv(params, enc_out: torch.Tensor, cfg: ArchConfig, pol: Policy
             ) -> Dict[str, torch.Tensor]:
    """Each decoder layer's cross K/V of the encoder output, stacked
    {"k", "v"} [L, B, KV, S_enc, hd]."""
    hd, kvh = cfg.resolved_head_dim, cfg.kv_heads
    n_dec = _n_layers(params["decoder"])
    statsbank.segment_sites("xkv", n_dec)
    ks, vs = [], []
    for li, layer_p in enumerate(_unstack(params["decoder"], n_dec)):
        with statsbank.segment_ctx("xkv", li):
            k = pol.dot(enc_out, layer_p["cross"]["wk"].to(enc_out.dtype))
            v = pol.dot(enc_out, layer_p["cross"]["wv"].to(enc_out.dtype))
        ks.append(_heads(k, kvh, hd))
        vs.append(_heads(v, kvh, hd))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_stack(params, dec_tokens: torch.Tensor, enc_kv, cfg: ArchConfig,
                 pol: Policy, caches=None, cache_index=0, mode: str = "train"):
    """The decoder over ``dec_tokens`` [B, S] -> (logits [B, S, V] in the
    activation dtype, caches).  Without caches the layers run in the
    ``dec`` segment (remat in training under ``cfg.remat``); with caches
    ({"k","v"} [L, B, KV, Smax, hd], updated in place) outside any
    segment, at positions ``cache_index`` (decode)."""
    act = DTYPES[cfg.activation_dtype]
    x = params["embed"][dec_tokens.long()].to(act)
    s = dec_tokens.shape[1]
    positions = (torch.full((s,), int(cache_index), dtype=torch.int32,
                            device=x.device) if mode == "decode"
                 else torch.arange(s, dtype=torch.int32, device=x.device))
    n_dec = _n_layers(params["decoder"])
    layers = _unstack(params["decoder"], n_dec)
    if caches is None:
        statsbank.segment_sites("dec", n_dec)
        for li, layer_p in enumerate(layers):
            def run(x, ek, ev, layer_p=layer_p, li=li):
                with statsbank.segment_ctx("dec", li):
                    y, _ = dec_block_apply(layer_p, x, {"k": ek, "v": ev},
                                           cfg, pol, positions, None,
                                           cache_index, mode)
                return y
            x = remat_call(run, cfg.remat and mode == "train", x,
                           enc_kv["k"][li], enc_kv["v"][li])
    else:
        # the reference scans the cached layers outside any segment: under
        # a session every layer visits the same unsegmented sites, one
        # entry shared by all of them (a bank of the training graph, keyed
        # under dec/, has none and raises KeyError)
        for li, layer_p in enumerate(layers):
            layer_c = {k: v[li] for k, v in caches.items()}
            with statsbank.shared_sites():
                x, _ = dec_block_apply(layer_p, x, {"k": enc_kv["k"][li],
                                                    "v": enc_kv["v"][li]},
                                       cfg, pol, positions, layer_c,
                                       cache_index, mode)
    x = apply_norm(params["dec_norm"], x, cfg)
    with statsbank.scope("head"):
        logits = pol.dot(x, params["head"].to(x.dtype))
    return logits, caches


def loss_fn(params, enc_inputs, dec_tokens, dec_labels, cfg: ArchConfig,
            pol: Policy):
    """Teacher-forced cross entropy plus the 1e-4 * mean(logz^2) z-loss ->
    (loss, {"nll": nll})."""
    enc_out = encode(params, enc_inputs, cfg, pol)
    ekv = cross_kv(params, enc_out, cfg, pol)
    logits, _ = decode_stack(params, dec_tokens, ekv, cfg, pol, mode="train")
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, dec_labels[..., None].long())[..., 0]
    nll = (logz - gold).mean()
    return nll + 1e-4 * (logz ** 2).mean(), {"nll": nll}


def init_dec_caches(cfg: ArchConfig, batch: int, max_dec_len: int,
                    dtype=torch.bfloat16, device=None
                    ) -> Dict[str, torch.Tensor]:
    """Self-attention caches {"k","v"} [L, B, KV, max_dec_len, hd]."""
    shape = (cfg.n_layers, batch, cfg.kv_heads, max_dec_len,
             cfg.resolved_head_dim)
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k in ("k", "v")}


def serve_prefill(params, enc_inputs, dec_bos, cfg: ArchConfig, pol: Policy,
                  max_dec_len: int = 448):
    """Encode, build the cross K/V, and run the BOS tokens [B, 1] through
    decode mode at index 0 -> (logits [B, 1, V], state {"ekv",
    "caches"})."""
    enc_out = encode(params, enc_inputs, cfg, pol)
    ekv = cross_kv(params, enc_out, cfg, pol)
    caches = init_dec_caches(cfg, enc_inputs.shape[0], max_dec_len,
                             device=enc_out.device)
    logits, caches = decode_stack(params, dec_bos, ekv, cfg, pol,
                                  caches=caches, cache_index=0, mode="decode")
    return logits, {"ekv": ekv, "caches": caches}


def serve_decode(params, token, state, cache_index: int, cfg: ArchConfig,
                 pol: Policy):
    """One token [B, 1] at ``cache_index`` -> (logits [B, 1, V], state;
    the caches updated in place)."""
    logits, caches = decode_stack(params, token, state["ekv"], cfg, pol,
                                  caches=state["caches"],
                                  cache_index=cache_index, mode="decode")
    return logits, {"ekv": state["ekv"], "caches": caches}
