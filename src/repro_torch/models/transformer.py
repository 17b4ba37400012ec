"""Decoder-only LM (port of ``repro.models.transformer`` for the dense,
``local``, ``attn``, ``dense_first``, ``moe``, ``mamba1`` and ``mamba2``
block types).

Params keep the reference's tree: ``embed`` [V, d], ``final_norm``, and
``segments`` — one dict per homogeneous run of layers with every leaf
stacked on a leading [L] axis.  The reference's ``lax.scan`` over a
segment becomes a Python loop over the layers of the unbound stacked
leaves (views, no copies; one backward node per leaf gathers the layers'
gradients).  Training remats each layer with ``torch.utils.checkpoint``
when ``cfg.remat`` (the reference's ``jax.checkpoint`` of the scan body);
the replay runs under the forward's StatsBank session, so it reads the
same stats and mints the same site keys, and it routes the MoE tokens as
the forward did (the routing is a deterministic function of the layer's
input: f32 router product, stable sorts), and it reruns an SSM layer's
scan forward, whose kernel gives the same bits on every launch.  The MoE
load-balance losses are summed over the layers into the loss.

Under the rules on a bound mesh (``parallel.sharding``) the LM computes
its part of the model axis: the blocks of ``blocks.TP_BLOCK_TYPES`` split
their heads, MLP and dense caches (``models/blocks.py``), and the vocab
splits the embedding (:func:`embed_tokens`: the rank's rows, other
tokens 0, summed over the axis), the head (:func:`lm_head`: the logits'
vocab slice) and the loss (:func:`loss_fn`: the cross entropy's max, sum
of exponentials and target logit combined over the axis).
:func:`compute_pspecs` says which stored splits the compute keeps.

Entry points: ``init_lm``, ``loss_fn``, ``prefill``, ``decode_step``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives, statsbank
from repro_torch.core.policy import TRUNCATING_MODES, Policy
from repro_torch.models import blocks
from repro_torch.parallel import sharding as shd

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
BLOCK_TYPES = blocks.ATTN_BLOCK_TYPES + ("mamba1", "mamba2")


def segments_of(cfg: ArchConfig) -> List[Tuple[str, int]]:
    """Group the layer pattern into maximal (block_type, run_length) runs."""
    runs: List[Tuple[str, int]] = []
    for t in cfg.resolved_pattern:
        if runs and runs[-1][0] == t:
            runs[-1] = (t, runs[-1][1] + 1)
        else:
            runs.append((t, 1))
    return runs


def _stack_layers(make, length: int):
    """The [L]-stacked tree of ``length`` layers made in order by
    ``make()``, each copied into the stack as soon as it is made (peak
    memory: the stack plus one layer)."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((length,) + tuple(t.shape), dtype=t.dtype,
                           device=t.device)

    def put(dst, src, i):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    layer = make()
    out = alloc(layer)
    put(out, layer, 0)
    for i in range(1, length):
        put(out, make(), i)
    return out


def init_lm(cfg: ArchConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random params from a seeded ``torch.Generator`` on ``device`` (the
    reference's per-leaf std; the numbers differ — JAX and PyTorch draw
    from different generators, see ``convert.params_from_jax``)."""
    dev = resolve_device(device)
    for btype, _ in segments_of(cfg):
        if btype not in BLOCK_TYPES:
            raise NotImplementedError(f"block type {btype!r} is not ported")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                             device=dev) * 0.02,
        "final_norm": blocks.init_norm(cfg, cfg.d_model, dev),
        "segments": [],
    }
    if not cfg.tie_embeddings:
        params["head"] = torch.randn((cfg.d_model, cfg.vocab), generator=gen,
                                     device=dev) / (cfg.d_model ** 0.5)
    for btype, length in segments_of(cfg):
        params["segments"].append(_stack_layers(
            lambda: blocks.init_block(btype, cfg, gen, dev), length))
    return params


def vocab_split(cfg: ArchConfig) -> Optional[shd.Split]:
    """The model-axis split of the vocab under the active rules."""
    return shd.split("vocab", cfg.vocab)


def embed_tokens(params, tokens, cfg: ArchConfig, pol: Policy):
    """Truncates the whole embedding table at the ``embed`` site in the
    truncating modes (as the reference does on every call; fp32 and bf16
    have no site), then gathers rows.  Vocab-parallel: the rank's rows of
    the table (its stats the whole table's), the tokens outside them 0,
    summed over the axis."""
    table = params["embed"]
    vs = vocab_split(cfg)
    if pol.mode in TRUNCATING_MODES:
        with statsbank.scope("embed"):
            table = pol.truncate(table, None if vs is None else vs.axis)
    if vs is None:
        return table[tokens].to(DTYPES[cfg.activation_dtype])
    n = table.shape[0]
    local = tokens - vs.coord * n
    mine = (local >= 0) & (local < n)
    rows = torch.where(mine[..., None], table[local.clamp(0, n - 1)], 0.0)
    return collectives.reduce_out(rows.float(), vs.axis).to(
        DTYPES[cfg.activation_dtype])


def lm_head(params, x, cfg: ArchConfig, pol: Policy):
    """Logits at the ``head`` site.  The tied head contracts x with the
    stored [V, d] table, x . E^T (the "nt" payload GEMM): no transpose is
    materialized, and the values are the reference's ``x @ E.T``.
    Vocab-parallel: the logits' vocab slice, from the rank's rows of the
    table (or columns of the untied head)."""
    tp = blocks.col_tp(vocab_split(cfg))
    with statsbank.scope("head"):
        if cfg.tie_embeddings:
            return pol.dot_general(x, params["embed"].to(x.dtype),
                                   (((x.dim() - 1,), (1,)), ((), ())), tp=tp)
        return pol.dot(x, params["head"].to(x.dtype), tp=tp)


def _unstack(tree, length: int) -> List[Any]:
    """Per-layer views of a stacked segment tree."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, length) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(length)]
    return list(torch.unbind(tree, 0))


def remat_call(fn, remat: bool, *args):
    """``fn(*args)``; with ``remat`` (and autograd on), rematerialized in
    the backward by ``torch.utils.checkpoint``, the replay under this
    forward's StatsBank session and sharding rules whatever thread the
    autograd engine uses."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    sess = statsbank.current_session()
    rules = shd.current_rules()
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _replay(sess, rules)))


@contextlib.contextmanager
def _replay(sess, rules):
    """The remat replay's context: the forward's session and rules."""
    with statsbank.resume(sess), shd.resume_rules(rules):
        yield


def forward(params, tokens, cfg: ArchConfig, pol: Policy, *, caches=None,
            cache_index=0, mode: str = "train",
            cache_fmt: Optional[str] = None):
    """Shared forward -> (hidden, total aux, caches).  ``caches``:
    per-segment dense caches (prefill, and SSM decode) or paged caches
    (attention decode), filled or updated in place, None in training;
    ``cache_index``: [B] per-slot positions (decode)."""
    x = embed_tokens(params, tokens, cfg, pol)
    s = tokens.shape[1]
    if mode == "decode":
        ci = torch.as_tensor(cache_index, dtype=torch.int32, device=x.device)
        positions = (ci[:, None].expand(ci.shape[0], s) if ci.dim() == 1
                     else torch.full((s,), int(ci), dtype=torch.int32,
                                     device=x.device))
    else:
        ci = None
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (btype, length) in enumerate(segments_of(cfg)):
        name = f"seg{i}:{btype}"
        # checks the bank's per-layer rows; a calibrating session learns
        # the segment length here for the sites it mints
        statsbank.segment_sites(name, length)
        seg_c = None if caches is None else caches[i]
        for li, layer_p in enumerate(_unstack(params["segments"][i],
                                              length)):
            layer_c = None if seg_c is None else _layer_cache(seg_c, li)

            def run(x, layer_p=layer_p, layer_c=layer_c, name=name, li=li,
                    btype=btype):
                with statsbank.segment_ctx(name, li):
                    y, _, aux = blocks.block_apply(
                        btype, layer_p, x, cfg, pol, positions, layer_c, ci,
                        mode, cache_fmt)
                return y, aux

            x, aux = remat_call(run, mode == "train" and cfg.remat, x)
            total_aux = total_aux + aux
    x = blocks.apply_norm(params["final_norm"], x, cfg)
    return x, total_aux, caches


def loss_fn(params, tokens, labels, cfg: ArchConfig, pol: Policy):
    """Next-token cross entropy plus the 1e-4 * logz^2 z-loss and the MoE
    load-balance aux (reference transformer.py:153-162) -> (loss, {"nll":
    nll, "aux": aux})."""
    x, aux, _ = forward(params, tokens, cfg, pol, mode="train")
    logits = lm_head(params, x, cfg, pol).float()
    vs = vocab_split(cfg)
    if vs is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[..., None].long())[..., 0]
    else:
        logz, gold = _vocab_parallel_terms(logits, labels, vs)
    nll = (logz - gold).mean()
    zloss = 1e-4 * (logz ** 2).mean()
    return nll + zloss + aux, {"nll": nll, "aux": aux}


def _vocab_parallel_terms(logits, labels, vs: shd.Split):
    """(logz, gold) of the rank's vocab slice of the logits: the max over
    the axis (a constant shift), the sum of exponentials summed over it,
    and the target logit from the rank holding it (the others add 0)."""
    n = logits.shape[-1]
    top = collectives.all_reduce(
        logits.detach().amax(dim=-1, keepdim=True).contiguous(), vs.axis,
        op="max")
    sumexp = collectives.reduce_out(
        torch.exp(logits - top).sum(dim=-1), vs.axis)
    logz = top[..., 0] + torch.log(sumexp)
    local = labels.long() - vs.coord * n
    mine = (local >= 0) & (local < n)
    picked = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = collectives.reduce_out(torch.where(mine, picked, 0.0), vs.axis)
    return logz, gold


def compute_pspecs(cfg: ArchConfig, specs):
    """The splits of a stored spec tree (``launch.api.param_pspecs``)
    that the model's compute keeps under the active rules on the bound
    mesh: a leaf's model-axis entry where its logical axis splits (the
    embedding's and the untied head's vocab, the ``TP_BLOCK_TYPES``
    blocks' query / K/V heads of ``wq`` / ``wk`` / ``wv`` / ``wo`` and the
    MLP's hidden dim), every other entry dropped (the leaf is gathered for
    use: ``parallel.sharding.Placement``)."""
    P = shd.PartitionSpec

    def keep(spec, sp):
        if sp is None or spec is None:
            return P()
        return P(*[e if e == sp.axis else None for e in spec])

    def drop(tree):
        if isinstance(tree, dict):
            return {k: drop(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [drop(v) for v in tree]
        return P()

    vs = vocab_split(cfg) if not cfg.enc_dec else None
    out = drop(specs)
    if cfg.enc_dec:
        return out
    out["embed"] = keep(specs["embed"], vs)
    if "head" in specs:
        out["head"] = keep(specs["head"], vs)
    for i, (btype, _) in enumerate(segments_of(cfg)):
        seg, got = specs["segments"][i], out["segments"][i]
        sp = blocks.attn_split(cfg, btype)
        if sp is not None:
            for name in ("wq", "wo"):
                got[name] = keep(seg[name], sp.heads)
            for name in ("wk", "wv"):
                got[name] = keep(seg[name], sp.kv)
        if "mlp" in seg:
            ms = blocks.mlp_split(cfg, btype, blocks.block_d_ff(cfg, btype))
            got["mlp"] = {k: keep(v, ms) for k, v in seg["mlp"].items()}
    return out


def _layer_cache(seg_cache, li: int):
    """Layer ``li``'s view of a segment cache (shared leaves pass through:
    the paged block table has no layer axis)."""
    return {k: (v[li] if k != "table" else v) for k, v in seg_cache.items()}


def init_caches(cfg: ArchConfig, batch: int, max_len: int, device=None,
                dtype=torch.float32) -> List[Dict[str, torch.Tensor]]:
    """Dense per-segment caches, each leaf of ``blocks.init_cache`` stacked
    on a leading [L] axis: attention {"k","v"} [L, B, KV, max_len, hd],
    mamba1 {"conv" [L, B, K-1, di] in ``dtype``, "ssm" [L, B, di, n]
    f32}, mamba2 {"conv" [L, B, K-1, di + 2n] in ``dtype``, "ssm" [L, B,
    nh, hd, n] f32}."""
    caches = []
    for btype, length in segments_of(cfg):
        shapes = blocks.init_cache(btype, cfg, batch, max_len, dtype, "meta")
        caches.append({k: torch.zeros((length,) + tuple(v.shape),
                                      dtype=v.dtype, device=device)
                       for k, v in shapes.items()})
    return caches


def prefill(params, tokens, cfg: ArchConfig, pol: Policy, caches, *,
            last_index=None):
    """Process full prompts [B, S], fill the dense caches (in place; None
    keeps no cache), return the logits at each row's ``last_index``
    (default: the last position) [B, 1, V]."""
    x, _, caches = forward(params, tokens, cfg, pol, caches=caches,
                           mode="prefill")
    if last_index is None:
        x_last = x[:, -1:]
    else:
        x_last = x[torch.arange(x.shape[0], device=x.device),
                   last_index.long()][:, None]
    return lm_head(params, x_last, cfg, pol), caches


def decode_step(params, token, cfg: ArchConfig, pol: Policy, caches,
                cache_index, *, cache_fmt: Optional[str] = None):
    """One decode step: token [B, 1], per-slot positions [B] -> logits
    [B, 1, V]; the caches (paged for attention, dense for mamba blocks) are
    updated in place."""
    x, _, caches = forward(params, token, cfg, pol, caches=caches,
                           cache_index=cache_index, mode="decode",
                           cache_fmt=cache_fmt)
    return lm_head(params, x, cfg, pol), caches
