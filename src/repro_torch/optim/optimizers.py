"""Optimizers with FP32 master weights (port of ``repro.optim.optimizers``).

The model may run its GEMMs in S2FP8/FP8, but the optimizer state — master
params, momenta — is FP32.  AdamW and SGD-momentum follow the reference's
update rules.  Trees are nested dicts/lists of tensors; the state mirrors
the params.  Unlike the reference's pure functions, ``update`` writes the
new params and moments into the existing tensors (under ``no_grad``) and
returns those same objects: at full width a second copy of params, m and
v would not fit beside the first.

Under a mesh the update runs on what the rank holds: replicated leaves,
or its FSDP shards (ZeRO-3), so the state mirrors the params leaf for
leaf either way.  ``global_norm(tree, axis_name=...)`` sums per-rank
partials across mesh axes, and inside :func:`fsdp_grads` it sums the
sharded leaves' squares over the fsdp axis and counts replicated leaves
once; ``clip_axis_name`` gives the clip of ``sgd_momentum`` / ``adamw``
the same psum-aware norm.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

_fsdp_scope = threading.local()


class OptState(NamedTuple):
    step: int
    m: Any            # momentum / first moment (tree or None)
    v: Any            # second moment (tree or None)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable    # params -> OptState
    update: Callable  # (grads, state, params, lr) -> (params, state)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of nested dicts/lists, dict entries in key order (as JAX
    orders them), so two trees of one structure pair up leaf by leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(like)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _zeros_like_f32(params):
    return _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)


@contextlib.contextmanager
def fsdp_grads(axis_name, sharded):
    """Declare that some leaves of the trees reaching :func:`global_norm`
    (and the optimizers' clip) are FSDP shards over ``axis_name``:
    ``sharded`` is a bool tree (or a list in leaf order), True where the
    leaf is a dim-0 shard of the logical leaf.  Inside the scope a tree
    with that many leaves gets the mixed norm: the sharded leaves' sums of
    squares are summed over the fsdp axis, replicated leaves count once.
    ``sharded`` may instead be a list in leaf order whose entries are
    tuples of mesh axes (a leaf placed by
    ``parallel.sharding.place_params``, split over each): each leaf's sum
    of squares is summed over its axes (``()``: replicated).
    Thread-local, as the reference's."""
    if isinstance(sharded, list) and all(
            isinstance(f, (bool, tuple)) for f in sharded):
        flags = [f if isinstance(f, tuple) else bool(f) for f in sharded]
    else:
        flags = [bool(f) for f in tree_leaves(sharded)]
    prev = getattr(_fsdp_scope, "v", None)
    _fsdp_scope.v = (axis_name, flags)
    try:
        yield
    finally:
        _fsdp_scope.v = prev


def global_norm(tree, axis_name=None) -> torch.Tensor:
    """L2 norm over every leaf of ``tree`` (f32, on the device).

    ``axis_name``: the leaves are per-rank partials (gradients before a
    sync); the sum of squares is all-reduced over those mesh axes before
    the square root.  Leave it None for replicated trees.  Inside an
    active :func:`fsdp_grads` scope (and with ``axis_name`` None) the
    sharded leaves' per-leaf sums of squares are all-reduced over the
    fsdp axis (one all-reduce of their stack) and summed with the
    replicated leaves' in leaf order — the same reductions as the
    meshless norm, in the same order."""
    leaves = tree_leaves(tree)
    # each leaf reduced in its contiguous layout: a gradient autograd leaves
    # strided (the tied embedding's) sums in the same order as its
    # contiguous copy from a collective, so the meshless step and a 1-rank
    # mesh step clip by the same bits
    sq = [torch.sum(torch.square(x.float().contiguous())) for x in leaves]
    scope = getattr(_fsdp_scope, "v", None)
    if axis_name is None and scope is not None \
            and len(scope[1]) == len(leaves):
        from repro_torch.core import collectives
        axis, flags = scope
        groups = {}
        for i, f in enumerate(flags):
            axes = f if isinstance(f, tuple) else ((axis,) if f else ())
            if axes:
                groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            part = collectives.all_reduce(
                torch.stack([sq[i] for i in idx]),
                axes[0] if len(axes) == 1 else axes)
            for j, i in enumerate(idx):
                sq[i] = part[j]
    total = torch.sum(torch.stack(sq))
    if axis_name is not None:
        from repro_torch.core import collectives
        total = collectives.all_reduce(total.reshape(1), axis_name)[0]
    return torch.sqrt(total)


def clip_scale(grads, max_norm: float, axis_name=None):
    """(the factor that brings the global L2 norm of ``grads`` to at most
    ``max_norm``, the norm), both on the device."""
    norm = global_norm(grads, axis_name=axis_name)
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0), norm


def clip_by_global_norm(grads, max_norm: float, axis_name=None):
    """(grads scaled so their global L2 norm is at most ``max_norm``, the
    norm before clipping); ``axis_name`` as in :func:`global_norm`."""
    scale, norm = clip_scale(grads, max_norm, axis_name)
    return _tree_map(lambda g: g * scale, grads), norm


def sgd_momentum(momentum: float = 0.9, weight_decay: float = 0.0,
                 clip_norm: Optional[float] = None,
                 clip_axis_name=None) -> Optimizer:
    def init(params):
        return OptState(0, _zeros_like_f32(params), None)

    @torch.no_grad()
    def update(grads, state, params, lr):
        scale = (clip_scale(grads, clip_norm, clip_axis_name)[0]
                 if clip_norm else None)
        for g, m, p in zip(tree_leaves(grads), tree_leaves(state.m),
                           tree_leaves(params)):
            g = g.float() if scale is None else g.float() * scale
            if weight_decay:
                g = g + weight_decay * p.float()
            m.mul_(momentum).add_(g)
            p.sub_(lr * m)
        return params, OptState(state.step + 1, state.m, None)

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, clip_norm: Optional[float] = 1.0,
          clip_axis_name=None) -> Optimizer:
    def init(params):
        return OptState(0, _zeros_like_f32(params), _zeros_like_f32(params))

    @torch.no_grad()
    def update(grads, state, params, lr):
        scale = (clip_scale(grads, clip_norm, clip_axis_name)[0]
                 if clip_norm else None)
        t = np.float32(state.step + 1)
        # bias corrections in f32, as the reference computes b ** t
        c1 = float(np.float32(1.0) - np.float32(b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(b2) ** t)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m),
                              tree_leaves(state.v), tree_leaves(params)):
            # the reference's ops in its order, in place where the
            # rounding allows, so one leaf's temporaries are all there is
            g = g.float() if scale is None else g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            step = (m / c1).mul_(lr).div_((v / c2).sqrt_().add_(eps))
            if weight_decay:
                step.add_(lr * weight_decay * p)
            p.sub_(step)
        return params, OptState(state.step + 1, state.m, state.v)

    return Optimizer(init, update)
