"""Carry weights across from the JAX package.

``params_from_jax(tree)`` takes the tree ``repro.launch.api.init_params``
returns — as numpy arrays (``jax.device_get``), or any array type numpy
can read — and gives the port's params: the same stacked segments, the
same leaf names, the same layout ([d_in, d_out] weights, [L]-stacked
layers), MoE blocks included (``moe/router`` [L, d, E], the stacked
experts ``moe/we_gate``, ``we_up`` [L, E, d, f] and ``we_down`` [L, E, f,
d], ``moe/shared/*``; kimi's 384 experts alike), the ``local`` and
``attn`` blocks (a ``dense`` block's leaves; a non-GLU MLP such as
nemotron's squared ReLU holds ``w_gate`` and ``w_down`` only), mamba1
blocks (``ln``, ``w_in`` [L, d, 2di],
``conv_w`` [L, K, di], ``conv_b``, ``w_x`` [L, di, dt_rank + 2n], ``w_dt``
[L, dt_rank, di], ``b_dt``, ``a_log`` [L, di, n], ``d_skip`` [L, di],
``w_out`` [L, di, d]), mamba2 blocks (``ln``, ``w_in`` [L, d, 2di + 2n +
nh], ``conv_w`` [L, K, di + 2n], ``conv_b``, ``a_log``, ``dt_bias`` and
``d_skip`` [L, nh], ``norm_scale`` [L, di], ``w_out``) and the untied
``head``.  The same call carries
the paper's models: ``repro.models.encdec.init_encdec``'s tree (``embed``,
``head``, ``enc_norm``, ``dec_norm``, the [L]-stacked ``encoder`` blocks
and ``decoder`` blocks with their ``self`` / ``cross`` projections and
layer norms' ``bias``), ``repro.models.resnet.init_resnet``'s (params,
state) (HWIO kernels, ``blocks`` a list of dicts, ``bns`` an empty list,
the batch norms' running ``mean`` / ``var``) and
``repro.models.ncf.init_ncf``'s tree (the tables, ``mlp`` a list).  Lists
stay lists and dicts keep their keys.  The two frameworks draw
different random numbers from the same seed, so parity tests start both
sides from these converted params; :func:`placed_from_jax` gives a mesh
rank its part of them, placed by ``param_pspecs``.

The whole train state crosses too, in both directions, leaf by leaf in
the order ``jax.tree_util.tree_flatten`` gives (dict entries by sorted
key, lists, tuples and NamedTuples in order, ``None`` no leaf):
:func:`jax_leaves` lists a port tree's leaves in that order (the port's
``OptState.step``, a Python int, as the reference's 0-d int32),
:func:`unflatten` rebuilds a port tree of a template's structure from
such leaves, and :func:`state_from_jax` converts a JAX tree read as
numpy (params, an ``OptState`` with ``step``, a StatsBank with or without
telemetry leaves, the guard state) without a template.  The checkpoint
manager writes and reads the port's state through them, which is what
keeps its files byte-compatible with the reference's.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from repro_torch import resolve_device


def params_from_jax(tree: Any, device=None) -> Any:
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.as_tensor(np.array(node, dtype=np.float32), device=dev)

    return conv(tree)


def placed_from_jax(tree: Any, mesh, specs=None, device=None) -> Any:
    """This rank's part of :func:`params_from_jax`'s tree, placed as
    ``launch.api.param_pspecs`` places it on ``mesh``
    (``parallel.sharding.place_params``; ``specs`` overrides the spec
    tree), so a mesh run starts from the same reference params as a
    meshless one."""
    from repro_torch.parallel import sharding
    return sharding.place_params(params_from_jax(tree, device), mesh,
                                 specs=specs)


def jax_leaves(tree) -> List[Any]:
    """``tree``'s leaves in JAX's flatten order: tensors as they are, a
    Python int (``OptState.step``) as a 0-d int32 array; ``None`` gives no
    leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in jax_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in jax_leaves(v)]
    if isinstance(tree, int):
        return [np.asarray(tree, np.int32)]
    return [tree]


def unflatten(like, leaves) -> Any:
    """A port tree of ``like``'s structure holding ``leaves`` (numpy
    arrays or tensors, in :func:`jax_leaves` order): each array becomes a
    new tensor on its template leaf's device (never a view of the array:
    the optimizer updates in place), an int leaf an int.  Dicts keep
    ``like``'s key order; NamedTuples keep their type."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            kids = [build(v) for v in node]
            if hasattr(node, "_fields"):
                return type(node)(*kids)
            return type(node)(kids)
        leaf = next(it, None)
        if leaf is None:
            raise ValueError("fewer leaves than the template holds")
        if isinstance(node, int):
            return int(np.asarray(leaf))
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.from_numpy(np.asarray(leaf))
        return leaf.to(device=node.device, copy=True)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def skeleton(tree) -> Any:
    """``tree``'s structure with every tensor replaced by an empty one of
    its dtype and device (a template for :func:`unflatten` that holds no
    memory)."""
    if tree is None or isinstance(tree, int):
        return tree
    if isinstance(tree, dict):
        return {k: skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [skeleton(v) for v in tree]
        return type(tree)(*kids) if hasattr(tree, "_fields") \
            else type(tree)(kids)
    return torch.empty(0, dtype=tree.dtype, device=tree.device)


def state_from_jax(tree: Any, device=None) -> Any:
    """A JAX train-state tree (as numpy) as the port's: dicts, lists and
    tuples kept, an ``OptState`` as the port's with ``step`` an int,
    arrays as tensors of the same dtype on ``device``."""
    from repro_torch.optim.optimizers import OptState
    dev = resolve_device(device)

    def conv(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if getattr(node, "_fields", None) == OptState._fields:
            return OptState(int(np.asarray(node.step)), conv(node.m),
                            conv(node.v))
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return torch.from_numpy(np.array(node)).to(dev)

    return conv(tree)
