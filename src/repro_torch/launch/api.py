"""Uniform model API for the launchers (port of the step-function half of
``repro.launch.api``).

Dispatch on ``cfg.enc_dec``: the encoder-decoder (``models/encdec.py``:
whisper_medium, transformer_tiny) or the decoder LM
(``models/transformer.py``: dense, local, attn, moe, mamba1 and mamba2
patterns).

    params = api.init_params(cfg, seed=0, device="cuda")
    loss, metrics = api.make_loss_fn(cfg)(params, batch, policy)
    step, opt = api.make_train_step(cfg, policy)     # AdamW, cosine / WSD
    logits, caches = api.make_prefill_step(cfg, policy)(params, batch,
                                                        caches)
    logits, caches = api.make_decode_step(cfg, policy)(params, batch,
                                                       caches, index)

Batches use the reference's keys: ``tokens`` / ``labels`` for an LM,
``enc_inputs`` (frame embeddings [B, S, d] or token ids [B, S]) /
``dec_tokens`` / ``dec_labels`` for an encoder-decoder; ``dec_bos`` [B, 1]
at an enc-dec prefill (whose step takes no caches: it builds the decoder
caches for ``WHISPER_DEC_LEN`` tokens and returns them with the cross
K/V as its state) and ``token`` [B, 1] at decode.

The PartitionSpec half (reference ``api.py:56-164``): ``param_pspecs``,
``cache_pspecs`` and ``batch_pspecs`` map a port tree to
``parallel.sharding.PartitionSpec``s by name-based rules over the leaf
names (the nearest dict key on the leaf's path), divisibility-guarded
against the mesh's axis sizes.  ``parallel.sharding.place_params`` cuts a
full tree to a rank's part by them, and :func:`placement` describes such
params to the steps, which run on a ``Mesh`` or ``DryMesh`` under the
caller's rules (``TRAIN_RULES`` / ``DECODE_RULES``).

The struct half (the reference's ShapeDtypeStructs): ``param_struct``,
``batch_struct`` and ``cache_struct`` build fake tensors
(``FakeTensorMode``: shapes, dtypes and devices on meta storage) of the
reference's leaves, keys and shapes, so a 1 T-parameter struct allocates
nothing.  They share one mode (:func:`fake_mode`), and a dry trace runs
inside it (``launch/dryrun.py``).  Token ids are int64 where the
reference's are int32 (the port's batches are int64); the rest keep the
reference's dtypes.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import SHAPE_SPECS, ArchConfig
from repro_torch.core.policy import Policy
from repro_torch.models import encdec
from repro_torch.models import transformer as tlm
from repro_torch.optim import optimizers, schedules

WHISPER_DEC_LEN = 448


# =========================================================================
# Sharding rules (name-based, divisibility-guarded)
# =========================================================================

# last-dims spec by leaf name; "T" = tensor-parallel axis ("model"),
# "F" = fsdp axis ("data").  Left-padded with None to the leaf's rank
# (covers the stacked leading layer dim).
_PARAM_RULES: Dict[str, Tuple] = {
    "embed": ("T", "F"),
    "head": ("F", "T"),
    "wq": ("F", "T"), "wk": ("F", "T"), "wv": ("F", "T"),
    "w_gate": ("F", "T"), "w_up": ("F", "T"), "w_in": ("F", "T"),
    "w_x": ("T", None),
    "wo": ("T", "F"), "w_down": ("T", "F"), "w_out": ("T", "F"),
    "w_dt": (None, "T"),
    "we_gate": ("T", "F", None), "we_up": ("T", "F", None),
    "we_down": ("T", None, "F"),
    "router": (None, "T"),
    "conv_w": (None, "T"),
    "a_log": ("T", None),
    # ncf / resnet leaves and all 1-D scales / biases: replicated
}

_CACHE_RULES: Dict[str, Tuple] = {
    "k": ("B", None, "S", None),     # [B, KV, Smax, hd] (after layer pad)
    "v": ("B", None, "S", None),
    "conv": ("B", None, "T"),        # [B, K-1, C]
    "ssm": ("B", "T", None),         # mamba1 [B, di, n]
}


def _resolve_tokens(tokens, shape, sizes, *, batch_axes, tp="model",
                    fsdp="data"):
    from repro_torch.parallel.sharding import PartitionSpec as P
    spec = []
    used = set()
    for dim, tok in zip(shape, tokens):
        if tok is None:
            spec.append(None)
            continue
        if tok == "T":
            axes = (tp,)
        elif tok == "F":
            axes = (fsdp,)
        elif tok == "B":
            axes = batch_axes
        elif tok == "S":
            axes = (tp,)
        else:
            axes = (tok,)
        axes = tuple(a for a in axes if a in sizes and a not in used)
        prod = 1
        for a in axes:
            prod *= sizes[a]
        if not axes or dim % prod != 0:
            spec.append(None)
        else:
            used.update(axes)
            spec.append(axes[0] if len(axes) == 1 else axes)
    return P(*spec)


def _map_named(fn, tree, name: str = ""):
    """``fn(name, leaf)`` over a tree's leaves, ``name`` the nearest dict
    key on the leaf's path (the reference's ``_leaf_name``)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [_map_named(fn, v, name) for v in tree]
        return type(tree)(*kids) if hasattr(tree, "_fields") \
            else type(tree)(kids)
    if tree is None:
        return None
    return fn(name, tree)


def _batch_axes(sizes) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in sizes)


def param_pspecs(cfg: ArchConfig, struct, sizes: Dict[str, int]):
    """Per-leaf PartitionSpecs of a param tree (tensors, fake or meta
    tensors, anything with ``.shape``) on a mesh of ``sizes``."""
    from repro_torch.parallel.sharding import PartitionSpec as P
    batch_axes = _batch_axes(sizes)

    def rule(name, leaf):
        toks = _PARAM_RULES.get(name)
        if toks is None:
            return P()
        shape = tuple(leaf.shape)
        toks = (None,) * (len(shape) - len(toks)) + tuple(toks)
        return _resolve_tokens(toks, shape, sizes, batch_axes=batch_axes)

    return _map_named(rule, struct)


def cache_pspecs(cfg: ArchConfig, struct, sizes: Dict[str, int],
                 shard_kv_seq: bool = True):
    """Per-leaf PartitionSpecs of a cache tree; ``shard_kv_seq=False``
    keeps the sequence axis unsharded."""
    from repro_torch.parallel.sharding import PartitionSpec as P
    batch_axes = _batch_axes(sizes)

    def rule(name, leaf):
        toks = _CACHE_RULES.get(name)
        if toks is None:
            return P()
        if not shard_kv_seq:
            toks = tuple(None if t == "S" else t for t in toks)
        shape = tuple(leaf.shape)
        toks = (None,) * (len(shape) - len(toks)) + tuple(toks)
        return _resolve_tokens(toks, shape, sizes, batch_axes=batch_axes)

    return _map_named(rule, struct)


def batch_pspecs(struct, sizes: Dict[str, int]):
    """Per-leaf PartitionSpecs of a batch tree: dim 0 over the batch axes
    where it divides, 0-d leaves replicated."""
    from repro_torch.parallel.sharding import PartitionSpec as P
    batch_axes = _batch_axes(sizes)

    def rule(_, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        toks = ("B",) + (None,) * (len(shape) - 1)
        return _resolve_tokens(toks, shape, sizes, batch_axes=batch_axes)

    return _map_named(rule, struct)


def init_params(cfg: ArchConfig, seed: int = 0, device=None):
    """Random params of ``cfg`` from ``seed`` on ``device`` (the card
    unless the caller asks for the CPU)."""
    if cfg.enc_dec:
        return encdec.init_encdec(cfg, seed=seed, device=device)
    return tlm.init_lm(cfg, seed=seed, device=device)


# =========================================================================
# Structs: fake tensors of the reference's shapes
# =========================================================================

_FAKE_MODE = []


def fake_mode():
    """The process's ``FakeTensorMode`` for structs: every struct is made
    in it, so structs from separate calls meet in one traced step.  Real
    tensors may enter it (module-level constants)."""
    if not _FAKE_MODE:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _FAKE_MODE.append(FakeTensorMode(allow_non_fake_inputs=True))
    return _FAKE_MODE[0]


def param_struct(cfg: ArchConfig, dtype=None):
    """The param tree of ``cfg`` as fake tensors on the CPU (every leaf in
    ``dtype`` when given)."""
    with fake_mode():
        params = init_params(cfg, seed=0, device="cpu")
        if dtype is not None:
            params = _map_named(lambda _, t: t.to(dtype), params)
    return params


def batch_struct(cfg: ArchConfig, shape_name: str):
    """The batch of one ``SHAPE_SPECS`` cell as fake tensors: train
    ``tokens`` / ``labels`` [gbs, seq] (enc-dec: bf16 ``enc_inputs`` [gbs,
    seq, d], ``dec_tokens`` / ``dec_labels`` [gbs, 448]), prefill
    ``tokens`` (enc-dec: ``enc_inputs`` and ``dec_bos`` [gbs, 1]), decode
    ``token`` [gbs, 1]."""
    seq, gbs, kind = SHAPE_SPECS[shape_name]
    ids = torch.int64
    with fake_mode():
        def t(shape, dtype=ids):
            return torch.empty(shape, dtype=dtype)
        if kind == "train":
            if cfg.enc_dec:
                return {"enc_inputs": t((gbs, seq, cfg.d_model),
                                        torch.bfloat16),
                        "dec_tokens": t((gbs, WHISPER_DEC_LEN)),
                        "dec_labels": t((gbs, WHISPER_DEC_LEN))}
            return {"tokens": t((gbs, seq)), "labels": t((gbs, seq))}
        if kind == "prefill":
            if cfg.enc_dec:
                return {"enc_inputs": t((gbs, seq, cfg.d_model),
                                        torch.bfloat16),
                        "dec_bos": t((gbs, 1))}
            return {"tokens": t((gbs, seq))}
        return {"token": t((gbs, 1))}


def cache_struct(cfg: ArchConfig, shape_name: str, dtype=torch.bfloat16):
    """The caches one cell's step takes, as fake tensors: prefill of a
    decoder LM its dense caches over ``seq``, decode the same (enc-dec:
    ``{"ekv": {"k", "v"} [L, gbs, KV, seq, hd], "caches": self-attention
    caches over 448 tokens}``); None where the step takes none."""
    seq, gbs, kind = SHAPE_SPECS[shape_name]
    with fake_mode():
        if kind != "decode":
            if kind == "prefill" and not cfg.enc_dec:
                return tlm.init_caches(cfg, gbs, seq, device="cpu",
                                       dtype=dtype)
            return None
        if cfg.enc_dec:
            shape = (cfg.n_layers, gbs, cfg.kv_heads, seq,
                     cfg.resolved_head_dim)
            ekv = {k: torch.empty(shape, dtype=dtype) for k in ("k", "v")}
            return {"ekv": ekv, "caches": encdec.init_dec_caches(
                cfg, gbs, WHISPER_DEC_LEN, dtype=dtype, device="cpu")}
        return tlm.init_caches(cfg, gbs, seq, device="cpu", dtype=dtype)


def make_loss_fn(cfg: ArchConfig) -> Callable:
    """``loss(params, batch, policy) -> (loss, metrics)``."""
    if cfg.enc_dec:
        def loss(params, batch, pol):
            return encdec.loss_fn(params, batch["enc_inputs"],
                                  batch["dec_tokens"], batch["dec_labels"],
                                  cfg, pol)
        return loss

    def loss(params, batch, pol):
        return tlm.loss_fn(params, batch["tokens"], batch["labels"], cfg, pol)
    return loss


def placement(cfg: ArchConfig, mesh, struct=None):
    """The ``parallel.sharding.Placement`` of ``cfg``'s params on ``mesh``:
    stored as :func:`param_pspecs` places them (``struct``: the full
    param tree or its struct; default :func:`param_struct`), used as the
    model computes under the rules active at each call
    (``models.transformer.compute_pspecs``)."""
    from repro_torch.parallel import sharding as shd
    specs = param_pspecs(cfg, param_struct(cfg) if struct is None
                         else struct, dict(mesh.shape))
    return shd.Placement(specs, lambda: tlm.compute_pspecs(cfg, specs),
                         mesh)


def make_train_step(cfg: ArchConfig, policy: Policy, lr: float = 1e-4,
                    **step_kw) -> Tuple[Callable, optimizers.Optimizer]:
    """(train step, AdamW) as the reference's: weight decay 0.01, the
    config's WSD or cosine schedule over 10,000 steps with 100 of warmup;
    the step is ``training.trainer.make_train_step``'s (params, opt_state,
    batch, step) -> (params, opt_state, metrics).  ``step_kw`` go to it
    (``stats``, ``mesh``, ``param_sharding``, ``placement``: params
    placed by ``sharding.place_params`` on the mesh, described by
    :func:`placement`)."""
    from repro_torch.training.trainer import make_train_step as mk
    opt = optimizers.adamw(weight_decay=0.01)
    sched = schedules.make_schedule(
        cfg.schedule if cfg.schedule in ("wsd", "cosine") else "cosine",
        lr, total_steps=10_000, warmup=100)
    return mk(make_loss_fn(cfg), opt, sched, policy, **step_kw), opt


def _placed(fn, where):
    """``fn`` run on ``where``'s mesh (bound) with its params (argument 0)
    as the model computes them, under the caller's rules; ``fn`` itself
    without a placement."""
    if where is None:
        return fn
    from repro_torch.core import collectives

    def step(params, *args):
        with collectives.bind(where.mesh):
            return fn(where.for_compute(params), *args)
    return step


def make_prefill_step(cfg: ArchConfig, policy: Policy, *,
                      placement=None) -> Callable:
    """``step(params, batch, caches)`` (enc-dec: ``step(params, batch)``).
    ``placement`` (:func:`placement`): the params are a rank's, placed by
    ``sharding.place_params`` on its mesh (a ``Mesh`` or ``DryMesh``), which
    the step binds, so under the caller's rules (``DECODE_RULES``) the
    model computes its part of the model axis, with the caches' ``S``
    entries split as :func:`cache_pspecs` places them.  The logits are the
    rank's vocab slice where the vocab splits."""
    if cfg.enc_dec:
        def step(params, batch):
            return encdec.serve_prefill(params, batch["enc_inputs"],
                                        batch["dec_bos"], cfg, policy,
                                        max_dec_len=WHISPER_DEC_LEN)
        return _placed(step, placement)

    def step(params, batch, caches):
        return tlm.prefill(params, batch["tokens"], cfg, policy, caches)
    return _placed(step, placement)


def make_decode_step(cfg: ArchConfig, policy: Policy, *,
                     placement=None) -> Callable:
    """``step(params, batch, caches, cache_index)``; ``placement`` as in
    :func:`make_prefill_step`."""
    if cfg.enc_dec:
        def step(params, batch, state, cache_index):
            return encdec.serve_decode(params, batch["token"], state,
                                       cache_index, cfg, policy)
        return _placed(step, placement)

    def step(params, batch, caches, cache_index):
        return tlm.decode_step(params, batch["token"], cfg, policy, caches,
                               cache_index)
    return _placed(step, placement)
