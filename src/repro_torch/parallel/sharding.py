"""Logical-axis sharding rules (port of ``repro.parallel.sharding``).

Models annotate tensors with *logical* axis names; a rule table maps those
to physical mesh axes.  The table is thread-local state set by the
launcher (``use_rules``); when unset every annotation is a no-op.

Physical meshes (launch/mesh.py):
    single-pod: ("data", "model") = (16, 16)
    multi-pod : ("pod", "data", "model") = (2, 16, 16)

Default rule tables (the reference's):

  TRAIN_RULES                             DECODE_RULES
    batch   -> (pod,) data                  batch   -> (pod,) data
    fsdp    -> data          (ZeRO-3)       fsdp    -> data
    heads / kv / mlp / expert / vocab       heads, kv -> None
            -> model                        kv_seq  -> model
    seq, kv_seq, conv, state -> None

The port has no GSPMD: each rank computes its own part and moves data
between ranks with explicit ``torch.distributed`` collectives
(core/collectives.py).  Under active rules with a mesh bound
(``collectives.bind``), the model code asks :func:`split` how a logical
axis splits over the non-batch mesh axes (the ``model`` axis; the batch
axes are the step's, which takes its rows itself): the axis, its size and
this rank's coordinate, or None where the rules replicate it, the mesh
has no such axis or it is 1 wide, or the divisibility guard keeps the
logical dim whole.  The models compute on their slice of every split
logical axis (``models/blocks.py``, ``models/transformer.py``), and
:func:`shard` cuts a whole tensor to its slice.  Without rules, or
without a bound mesh, :func:`shard` checks its rank argument and returns
the tensor unchanged.  The mesh-native step that ``launch/train.py``
builds suspends the rules (``suspend_rules``), as the reference's does.

Params live where ``launch.api.param_pspecs`` puts them
(:func:`place_params`: ``T`` entries over ``model``, ``F`` over
``data``); a :class:`Placement` gathers, for each use, every dim stored
split over an axis along which the model computes whole
(``collectives.gather_for_use``).  The rest of the module is the spec
arithmetic of the data-parallel and FSDP step: which batch and param
leaves split over which mesh axes (:func:`mesh_batch_specs`,
:func:`fsdp_param_specs`, :func:`train_step_specs`), and
:func:`shard_tree` / :func:`gather_tree`, which move a tree between full
leaves and the rank's dim-0 shards.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

_state = threading.local()

# the attribute that marks a tensor as this rank's dim-0 FSDP shard of a
# larger logical leaf (set by shard_tree, read by the train step, the
# checkpoint manager and gather_tree)
_SHARD_MARK = "_fsdp_shard"


class PartitionSpec(tuple):
    """The port's ``PartitionSpec``: a tuple of entries, each ``None``, a
    mesh axis name, or a tuple of names.  Compares equal to the plain tuple
    of its entries (and so to ``tuple(jax.sharding.PartitionSpec(...))``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

TRAIN_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "embed": None,
    "heads": ("model",),
    "kv": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "vocab": ("model",),
    "seq": None,
    "kv_seq": None,
    "conv": None,
    "state": None,
}

DECODE_RULES = dict(TRAIN_RULES)
DECODE_RULES.update({
    # flash-decode style: the KV-cache sequence axis carries the model
    # axis; head axes stay replicated
    "heads": None,
    "kv": None,
    "kv_seq": ("model",),
})


def _rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


def _mesh_axes() -> Tuple[str, ...]:
    return getattr(_state, "mesh_axes", ())


def _axis_sizes() -> Dict[str, int]:
    return getattr(_state, "axis_sizes", {})


@contextlib.contextmanager
def use_rules(rules: dict, mesh_axes,
              axis_sizes: Optional[Dict[str, int]] = None):
    """Activate a logical->physical table in this thread.  ``mesh_axes``
    may be a tuple of names or a dict name -> size; sizes enable the
    divisibility guard (a logical axis whose dim does not divide by its
    mesh axes is replicated)."""
    if isinstance(mesh_axes, dict):
        axis_sizes = dict(mesh_axes)
        mesh_axes = tuple(mesh_axes)
    prev = (_rules(), _mesh_axes(), _axis_sizes())
    _state.rules = rules
    _state.mesh_axes = tuple(mesh_axes)
    _state.axis_sizes = axis_sizes or {}
    try:
        yield
    finally:
        _state.rules, _state.mesh_axes, _state.axis_sizes = prev


@contextlib.contextmanager
def suspend_rules():
    """Deactivate the rule table in this thread (the mesh-native train
    step runs its body under it, as the reference's does)."""
    prev = (_rules(), _mesh_axes(), _axis_sizes())
    _state.rules, _state.mesh_axes, _state.axis_sizes = None, (), {}
    try:
        yield
    finally:
        _state.rules, _state.mesh_axes, _state.axis_sizes = prev


def resolve(*logical: Optional[str]) -> PartitionSpec:
    """Logical axis names -> PartitionSpec under the active rules."""
    rules = _rules()
    mesh_axes = set(_mesh_axes())
    if rules is None:
        return P()
    spec, used = [], set()
    for name in logical:
        if name is None:
            spec.append(None)
            continue
        phys = rules.get(name)
        if phys is None:
            spec.append(None)
            continue
        # keep only axes present on this mesh and not already consumed
        keep = tuple(a for a in phys if a in mesh_axes and a not in used)
        used.update(keep)
        if not keep:
            spec.append(None)
        elif len(keep) == 1:
            spec.append(keep[0])
        else:
            spec.append(keep)
    return P(*spec)


def _guard(shape, spec) -> PartitionSpec:
    """``spec`` with every entry whose dim does not divide by the product
    of its mesh axes replaced by None."""
    sizes = _axis_sizes()
    guarded = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            guarded.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        prod = 1
        for a in axes:
            prod *= sizes.get(a, 1)
        guarded.append(entry if (prod > 0 and dim % prod == 0) else None)
    return P(*guarded)


class Split(NamedTuple):
    """How a logical axis splits: over mesh ``axis`` of ``size`` ranks,
    this rank at ``coord``."""
    axis: str
    size: int
    coord: int

    def part(self, n: int) -> int:
        """This rank's share of ``n`` entries."""
        return n // self.size

    def lo(self, n: int) -> int:
        """The first of this rank's entries of ``n``."""
        return self.coord * (n // self.size)

    def take(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of ``x``'s whole ``dim`` (a view)."""
        n = x.shape[dim]
        return x.narrow(dim, self.lo(n), self.part(n))


def current_rules():
    """The active (rules, mesh axes, sizes), for :func:`resume_rules` in
    another thread (the remat replay, the autograd engine)."""
    return (_rules(), _mesh_axes(), _axis_sizes())


@contextlib.contextmanager
def resume_rules(snapshot):
    """Activate a :func:`current_rules` snapshot in this thread."""
    prev = current_rules()
    _state.rules, _state.mesh_axes, _state.axis_sizes = snapshot
    try:
        yield
    finally:
        _state.rules, _state.mesh_axes, _state.axis_sizes = prev


def split(logical: Optional[str], n: int) -> Optional[Split]:
    """The split of a logical dim of ``n`` entries under the active rules
    on the bound mesh, over the rules' non-batch mesh axes (the model
    axis): None without rules or a bound mesh, where the rules replicate
    the axis or map it to an axis the mesh lacks or holds 1 wide, or where
    ``n`` does not divide by the axis (the reference's guard)."""
    sp = _mapped(logical)
    return None if sp is None or n % sp.size else sp


def axis_size(logical: Optional[str]) -> int:
    """The size of the mesh axis :func:`split` would split a logical axis
    over, whatever its length (1 where it would not)."""
    sp = _mapped(logical)
    return 1 if sp is None else sp.size


def _mapped(logical: Optional[str]) -> Optional[Split]:
    """:func:`split` before the divisibility guard."""
    rules = _rules()
    if rules is None or logical is None:
        return None
    from repro_torch.core import collectives
    mesh = collectives.bound()
    if mesh is None:
        return None
    batch = set(rules.get("batch") or ())
    axes = [a for a in (rules.get(logical) or ())
            if a in mesh.shape and a not in batch and mesh.shape[a] > 1]
    if len(axes) > 1:
        raise NotImplementedError(f"logical axis {logical!r} splits over "
                                  f"several mesh axes {axes}")
    if not axes:
        return None
    return Split(axes[0], mesh.shape[axes[0]], mesh.coords[axes[0]])


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Annotate an activation: the reference's rank check, then this
    rank's slice of every dim whose logical axis :func:`split` splits
    (``x`` itself where none does; see the module docstring)."""
    if _rules() is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"shard(): {len(logical)} axes for rank-{x.dim()} "
                         f"tensor")
    for dim, name in enumerate(logical):
        sp = split(name, x.shape[dim])
        if sp is not None:
            x = sp.take(x, dim)
    return x


def guarded_spec(shape, *logical: Optional[str]) -> PartitionSpec:
    """The PartitionSpec :func:`shard`'s guard gives a tensor of ``shape``."""
    if _rules() is None:
        return P()
    return _guard(shape, resolve(*logical))


def active() -> bool:
    return _rules() is not None


# ---------------------------------------------------------------------------
# trees (nested dicts / lists / tuples, NamedTuples kept; dict keys in
# sorted order as JAX flattens them)
# ---------------------------------------------------------------------------

def _leaves(tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping dicts, lists, tuples and NamedTuples; ``None``
    stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        kids = [_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*kids)
        return type(tree)(kids)
    return fn(tree, *rest)


def _ndim(leaf) -> int:
    shape = getattr(leaf, "shape", ())
    return len(tuple(shape))


def _is_float(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    return False


# ---------------------------------------------------------------------------
# mesh-level spec resolution for the mesh-native train step
# ---------------------------------------------------------------------------

def mesh_batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes that carry the batch under the active rule table
    (``TRAIN_RULES`` when none is active): ``("data",)`` on the host and
    single-pod meshes, ``("pod", "data")`` multi-pod."""
    rules = _rules() or TRAIN_RULES
    phys = rules.get("batch") or ()
    return tuple(a for a in phys if a in mesh.axis_names)


def mesh_batch_size(mesh) -> int:
    """Product of the batch-carrying mesh axis sizes."""
    n = 1
    for a in mesh_batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def batch_is_sharded(tree, mesh) -> bool:
    """The all-or-nothing divisibility guard of :func:`mesh_batch_specs`:
    False means every shard computes the full batch (integer count metrics
    must then be divided back by the shard count)."""
    axes = mesh_batch_axes(mesh)
    n = mesh_batch_size(mesh)
    leaves = [l for l in _leaves(tree) if _ndim(l) >= 1]
    return bool(axes) and bool(leaves) and all(
        leaf.shape[0] % n == 0 for leaf in leaves)


def mesh_batch_specs(tree, mesh):
    """Per-leaf PartitionSpecs sharding dim 0 of every batch leaf over the
    mesh's batch axes, all or nothing across the tree
    (:func:`batch_is_sharded`); 0-d leaves are replicated."""
    axes = mesh_batch_axes(mesh)
    entry = axes[0] if len(axes) == 1 else axes
    shardable = batch_is_sharded(tree, mesh)

    def spec(leaf):
        if not shardable or _ndim(leaf) == 0:
            return P()
        return P(entry)

    return _map(spec, tree)


def fsdp_axis_entry(mesh) -> Optional[str]:
    """The mesh axis carrying the ``fsdp`` logical axis under the active
    rule table (``TRAIN_RULES`` when none is active), or None."""
    rules = _rules() or TRAIN_RULES
    phys = rules.get("fsdp") or ()
    axes = tuple(a for a in phys if a in mesh.axis_names)
    return axes[0] if axes else None


def fsdp_axis_size(mesh) -> int:
    """Size of the fsdp-carrying mesh axis (1 when the mesh has none)."""
    axis = fsdp_axis_entry(mesh)
    return mesh.shape[axis] if axis is not None else 1


def fsdp_leaf_eligible(shape, dtype, axis_size: int) -> bool:
    """Whether one param or optimizer leaf shards over the fsdp axis: a
    float dtype, rank >= 1, and dim 0 divisible by the axis size."""
    if not _is_float(dtype):
        return False
    if len(shape) == 0 or shape[0] == 0:
        return False
    return shape[0] % axis_size == 0


def fsdp_param_specs(tree, mesh):
    """Per-leaf PartitionSpecs sharding dim 0 of every eligible param (or
    optimizer-state) leaf over the fsdp axis; the others replicate."""
    axis = fsdp_axis_entry(mesh)
    if axis is None:
        return _map(lambda _: P(), tree)
    n = mesh.shape[axis]

    def spec(leaf):
        if isinstance(leaf, torch.Tensor) and fsdp_leaf_eligible(
                tuple(leaf.shape), leaf.dtype, n):
            return P(axis)
        return P()

    return _map(spec, tree)


def train_step_specs(batch, mesh, with_stats: bool = False,
                     with_guard: bool = False,
                     param_sharding: str = "replicated",
                     params=None, opt_state=None):
    """(in_specs, out_specs) of the mesh-native train step: params,
    optimizer state (dim-0 shards under ``fsdp`` / ``fsdp_q``), the bank
    and the guard carry (replicated), the batch (:func:`mesh_batch_specs`)
    and the step (replicated); out: the carry, then the replicated
    metrics."""
    tail = int(with_stats) + int(with_guard)
    if param_sharding == "replicated":
        carry_in = (P(), P())
    else:
        if params is None or opt_state is None:
            raise ValueError("param_sharding != 'replicated' needs the "
                             "concrete params/opt_state trees for per-leaf "
                             "spec resolution")
        carry_in = (fsdp_param_specs(params, mesh),
                    fsdp_param_specs(opt_state, mesh))
    in_specs = carry_in + (P(),) * tail \
        + (mesh_batch_specs(batch, mesh), P())
    out_specs = carry_in + (P(),) * (tail + 1)      # carry + metrics
    return in_specs, out_specs


# ---------------------------------------------------------------------------
# moving trees between full leaves and this rank's shards
# ---------------------------------------------------------------------------

def batch_shard_index(mesh) -> int:
    """This rank's index among the batch shards: its coordinates on the
    batch axes, the first axis major (how a ``P(("pod", "data"))`` dim
    splits)."""
    i = 0
    for a in mesh_batch_axes(mesh):
        i = i * mesh.shape[a] + mesh.coords[a]
    return i


def shard_batch(batch, mesh):
    """This rank's slice of dim 0 of every >= 1-D batch leaf when the batch
    splits over the batch axes (:func:`batch_is_sharded`), else ``batch``
    itself (every rank computes the full batch)."""
    if not batch_is_sharded(batch, mesh):
        return batch
    n = mesh_batch_size(mesh)
    i = batch_shard_index(mesh)

    def take(leaf):
        if _ndim(leaf) == 0:
            return leaf
        rows = leaf.shape[0] // n
        return leaf[i * rows:(i + 1) * rows]

    return _map(take, batch)


def is_shard(leaf) -> bool:
    """Whether ``leaf`` is this rank's dim-0 FSDP shard (set by
    :func:`shard_tree` and :func:`mark_shards`)."""
    return bool(getattr(leaf, _SHARD_MARK, False))


def mark_shards(tree, flags):
    """Mark the leaves of ``tree`` whose entry of ``flags`` (a list in leaf
    order) is True as FSDP shards; returns ``tree``."""
    for leaf, f in zip(_leaves(tree), flags):
        if f and isinstance(leaf, torch.Tensor):
            setattr(leaf, _SHARD_MARK, True)
    return tree


def shard_flags(tree) -> List[bool]:
    """:func:`is_shard` of every leaf, in leaf order."""
    return [is_shard(x) for x in _leaves(tree)]


def shard_tree(tree, mesh, param_sharding: str = "fsdp"):
    """This rank's view of a full param or optimizer-state tree: under
    ``fsdp`` / ``fsdp_q``, every leaf :func:`fsdp_param_specs` shards
    becomes a contiguous copy of this rank's dim-0 slice (its coordinate
    on the fsdp axis), marked as a shard; the other leaves, and every
    leaf under ``replicated``, are returned as they are."""
    if param_sharding == "replicated":
        return tree
    axis = fsdp_axis_entry(mesh)
    if axis is None:
        raise ValueError(f"param_sharding={param_sharding!r} needs a mesh "
                         f"whose axes carry the rule table's 'fsdp' "
                         f"logical axis")
    n = mesh.shape[axis]
    c = mesh.coords[axis]

    def one(leaf):
        if not (isinstance(leaf, torch.Tensor) and fsdp_leaf_eligible(
                tuple(leaf.shape), leaf.dtype, n)):
            return leaf
        rows = leaf.shape[0] // n
        # one shard is the whole leaf: a new tensor object on its storage
        out = (leaf.detach() if n == 1
               else leaf[c * rows:(c + 1) * rows].detach().clone())
        setattr(out, _SHARD_MARK, True)
        return out

    return _map(one, tree)


def mark_opt_state(opt_state, params):
    """Mark the moment trees of an optimizer state made from sharded
    ``params`` (``OptState.m`` / ``.v`` mirror the params leaf for leaf)
    as the params are marked; returns ``opt_state``."""
    flags = shard_flags(params)
    for field in ("m", "v"):
        sub = getattr(opt_state, field, None)
        if sub is not None:
            mark_shards(sub, flags)
    return opt_state


def gather_tree(tree, mesh):
    """The full leaves of a tree of this rank's shards: every marked leaf
    all-gathered over the fsdp axis along dim 0 (a new tensor), the others
    as they are.  Every rank must call it (it is a collective)."""
    from repro_torch.core import collectives
    axis = fsdp_axis_entry(mesh)

    def one(leaf):
        if not is_shard(leaf):
            return leaf
        return collectives.all_gather(leaf.detach(), axis, mesh=mesh)

    return _map(one, tree)


def full_template(tree, mesh):
    """A tree of ``tree``'s structure whose marked leaves are empty tensors
    of the full logical shape (dim 0 times the fsdp axis size), on their
    devices, for reading a full checkpoint into."""
    n = fsdp_axis_size(mesh)

    def one(leaf):
        if not is_shard(leaf):
            return leaf
        return torch.empty((leaf.shape[0] * n,) + tuple(leaf.shape[1:]),
                           dtype=leaf.dtype, device=leaf.device)

    return _map(one, tree)


def reshard_like(full, like, mesh):
    """``full`` (full leaves) cut to this rank's shards wherever the
    matching leaf of ``like`` is a marked shard."""
    axis = fsdp_axis_entry(mesh)
    n = fsdp_axis_size(mesh)
    c = mesh.coords[axis] if axis is not None else 0

    def one(f, l):
        if not is_shard(l):
            return f
        rows = f.shape[0] // n
        out = f[c * rows:(c + 1) * rows].contiguous().clone()
        setattr(out, _SHARD_MARK, True)
        return out

    return _map(one, full, like)


# ---------------------------------------------------------------------------
# params placed by launch.api.param_pspecs
# ---------------------------------------------------------------------------

def _entries(spec) -> List[Tuple[int, str]]:
    """(dim, mesh axis) of every axis a spec's entries name."""
    out = []
    for dim, entry in enumerate(spec or ()):
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            out.append((dim, a))
    return out


def _map_spec(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its PartitionSpec tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_spec(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        kids = [_map_spec(fn, v, specs[i]) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*kids)
        return type(tree)(kids)
    return fn(tree, specs)


def param_specs(params, sizes: Dict[str, int], cfg=None):
    """``launch.api.param_pspecs`` of a full param tree on a mesh of
    ``sizes`` (name -> size)."""
    from repro_torch.launch.api import param_pspecs
    return param_pspecs(cfg, params, dict(sizes))


def place_params(params, mesh, sizes: Optional[Dict[str, int]] = None,
                 specs=None):
    """This rank's part of a full param tree placed as
    ``launch.api.param_pspecs`` places it on a mesh of ``sizes`` (default
    ``mesh.shape``): every dim a spec entry names cut to this rank's
    slice over that axis (``T`` over ``model``, ``F`` over ``data``; an
    axis 1 wide cuts nothing), each cut leaf a contiguous copy.  ``specs``
    overrides the spec tree."""
    specs = param_specs(params, sizes or mesh.shape) if specs is None \
        else specs

    def one(leaf, spec):
        out = leaf
        for dim, a in _entries(spec):
            n = mesh.shape[a]
            if n > 1:
                size = out.shape[dim] // n
                out = out.narrow(dim, mesh.coords[a] * size, size)
        return out if out is leaf else out.detach().clone()

    return _map_spec(one, params, specs)


def unplace_params(local, mesh, specs):
    """The inverse of :func:`place_params`: every placed dim all-gathered
    over its axis (a collective: every rank calls it), for checkpoints and
    tests; ``specs`` the full tree's spec tree."""
    from repro_torch.core import collectives

    def one(leaf, spec):
        out = leaf.detach()
        for dim, a in reversed(_entries(spec)):
            if mesh.shape[a] > 1:
                out = collectives.gather_dim(out, a, dim, mesh=mesh)
        return out

    return _map_spec(one, local, specs)


class Placement:
    """Params stored as :func:`place_params` leaves them, used as the model
    computes.  ``specs``: the full tree's storage spec tree
    (``launch.api.param_pspecs``); ``compute_specs()``: the spec tree of
    the splits the model's own compute keeps under the active rules (a
    subset of the model-axis entries, read at each use).  A dim stored
    split over an axis the compute keeps whole is all-gathered for use
    (:meth:`for_compute`): over a batch axis (``F`` -> ``data``) the
    gradient is reduce-scattered back, summed over the other batch axes
    first (the ranks hold partial gradients of their rows); over ``model``
    every rank holds the whole gradient and keeps its slice."""

    def __init__(self, specs, compute_specs: Callable[[], Any], mesh):
        self.specs = specs
        self.compute_specs = compute_specs
        self.mesh = mesh
        self.batch_axes = mesh_batch_axes(mesh)

    def stored_axes(self) -> List[Tuple[str, ...]]:
        """Per leaf (in leaf order), the axes its storage splits over."""
        return [tuple(a for _, a in _entries(sp) if self.mesh.shape[a] > 1)
                for sp in _spec_leaves(self.specs)]

    def batch_reduced(self) -> List[bool]:
        """Per leaf, whether its gradient leaves :meth:`for_compute`
        already summed over the batch axes (a dim stored over one)."""
        return [any(a in self.batch_axes for a in axes)
                for axes in self.stored_axes()]

    def for_compute(self, local):
        """The leaves as the model computes on them (differentiable)."""
        from repro_torch.core import collectives
        keep = self.compute_specs()
        mesh = self.mesh

        def one(leaf, spec, kept):
            kept = set(_entries(kept))
            out = leaf
            for dim, a in reversed(_entries(spec)):
                if mesh.shape[a] == 1 or (dim, a) in kept:
                    continue
                if a in self.batch_axes:
                    lead = tuple(b for b in self.batch_axes if b != a)
                    out = collectives.gather_for_use(
                        out, a, dim, "reduce_scatter", lead, mesh=mesh)
                else:
                    out = collectives.gather_for_use(out, a, dim, "slice",
                                                     mesh=mesh)
            return out

        def walk(tree, specs, kept):
            if isinstance(tree, dict):
                return {k: walk(tree[k], specs[k], kept[k]) for k in tree}
            if isinstance(tree, (list, tuple)):
                return type(tree)(walk(v, specs[i], kept[i])
                                  for i, v in enumerate(tree))
            return one(tree, specs, kept)

        return walk(local, self.specs, keep)


def _spec_leaves(specs) -> List[PartitionSpec]:
    """The PartitionSpecs of a spec tree, in leaf order."""
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    if isinstance(specs, (list, tuple)):
        return [x for v in specs for x in _spec_leaves(v)]
    return [P()]
