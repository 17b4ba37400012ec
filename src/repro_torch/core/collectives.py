"""S2FP8-compressed gradient synchronization and the FSDP gather / scatter
pair over ``torch.distributed`` (port of ``repro.core.collectives``).

S2FP8 is a nonlinear code, so payloads cannot be summed; the all-reduce is
split into its two legs::

    all_reduce(g)  ==  all_gather(reduce_scatter(g))

  * reduce-scatter leg: arithmetic, in bf16 (2 bytes an element);
  * all-gather leg: data movement — each rank S2FP8-encodes its reduced
    shard (1 byte an element + 8 bytes of stats) and the payloads gather.

Axis names resolve to the process groups of a :class:`launch.mesh.Mesh`:
the one passed (``mesh=``), else the one the caller bound for the duration
of its work with :func:`bind` (the mesh-native train step binds its mesh
around the step, so the StatsBank refreshes deep inside the model and the
autograd engine's thread see it too).  A tuple of axes reduces over each
in turn.

Every collective of the port goes through :func:`all_reduce`,
:func:`reduce_scatter` and :func:`all_gather`.  On a ``launch.mesh.DryMesh``
(no process group: a dry trace's) each records itself and returns a tensor
of its result's shape without communicating.  Inside :func:`recording`
each call appends ``{"op", "dtype", "numel", "out_numel", "out_shape",
"axis"}`` to the returned list, which is how the tests and ``chip_smoke.py`` count them.

Two API levels, as in the reference:

  * axis level (``grad_sync_axis`` / ``compressed_allreduce_axis``): the
    mesh-native train step's gradient sync, leaf by leaf, each leaf routed
    by :func:`leaf_sync_route`;
  * mesh level (``compressed_grad_sync`` / ``compressed_allreduce_1d``):
    averaging wrappers over replicated inputs, the numerics test surface.

The FSDP half: ``make_param_gather`` is a ``torch.autograd.Function``
whose forward all-gathers an owner shard along dim 0 and whose backward is
:func:`param_scatter_axis` (the gradient reduce-scattered back to the
owner); :class:`FSDPPayloadParam` carries a payload-eligible shard into the
loss function, where ``qdot_train`` gathers its 1-byte payload into the
payload GEMM's B slot and every other use takes the f32 gather.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core import backend as nbackend
from repro_torch.core.s2fp8 import S2FP8Tensor

AxisName = Union[str, Tuple[str, ...]]

_BOUND: List = [None]              # process-wide: autograd threads see it
_RECORDS: List[List[dict]] = []      # the open recordings, outermost first


@contextlib.contextmanager
def bind(mesh):
    """Resolve axis names against ``mesh`` while the context is open (in
    every thread of the process)."""
    prev = _BOUND[0]
    _BOUND[0] = mesh
    try:
        yield mesh
    finally:
        _BOUND[0] = prev


def bound():
    """The mesh bound by :func:`bind`, or None."""
    return _BOUND[0]


@contextlib.contextmanager
def recording():
    """Record every collective issued while open; yields the list.
    Recordings nest: each open one gets every record."""
    out: List[dict] = []
    _RECORDS.append(out)
    try:
        yield out
    finally:
        _RECORDS.remove(out)


def _record(op: str, t: torch.Tensor, out_shape, axis) -> None:
    if _RECORDS:
        n = 1
        for d in out_shape:
            n *= d
        entry = {"op": op, "dtype": str(t.dtype).replace("torch.", ""),
                 "numel": t.numel(), "out_numel": n,
                 "out_shape": tuple(out_shape), "axis": axis}
        for rec in _RECORDS:
            rec.append(dict(entry))


def _axes(axis: AxisName) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _mesh(mesh):
    mesh = mesh if mesh is not None else _BOUND[0]
    if mesh is None:
        raise RuntimeError("no mesh: pass mesh= or bind one "
                           "(collectives.bind)")
    return mesh


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _dry_fill(fn) -> None:
    """Give a dry collective's result on real tensors defined values
    (``fn`` writes them), out of sight of any dispatch mode: a dry trace
    counts the same on fake and on real tensors, and a real run on a
    ``DryMesh`` (rank 0 of a mesh on one card) computes on finite
    numbers.  The callers leave fake tensors, which hold no data, as they
    are."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        fn()


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t) or t.device.type == "meta"


def all_reduce(t: torch.Tensor, axis: AxisName, *, op: str = "sum",
               mesh=None) -> torch.Tensor:
    """``op``-reduce ``t`` over the axis (or each axis of a tuple, in
    order), in place on a contiguous ``t``; returns the result."""
    m = _mesh(mesh)
    _record("all_reduce", t, t.shape, axis)
    if not t.is_contiguous():
        t = t.contiguous()
    if m.groups is None:
        return t
    for a in _axes(axis):
        dist.all_reduce(t, op=_OPS[op], group=m.groups[a])
    return t


def reduce_scatter(t: torch.Tensor, axis: str, *, mesh=None
                   ) -> torch.Tensor:
    """Sum ``t`` over the axis and keep this rank's dim-0 slice (the
    tiled ``psum_scatter``); dim 0 must divide by the axis size."""
    m = _mesh(mesh)
    n = m.shape[axis]
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of {tuple(t.shape)} does "
                         f"not divide by the {n}-way axis {axis!r}")
    out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _record("reduce_scatter", t, out.shape, axis)
    if m.groups is None:
        if not _is_fake(t):
            # rank 0's slice of its own operand
            _dry_fill(lambda: out.copy_(t[:out.shape[0]]))
        return out
    dist.reduce_scatter_tensor(out, t.contiguous(), op=dist.ReduceOp.SUM,
                               group=m.groups[axis])
    return out


def all_gather(t: torch.Tensor, axis: str, *, mesh=None) -> torch.Tensor:
    """Concatenate every rank's ``t`` along dim 0 in axis order (the tiled
    ``all_gather``)."""
    m = _mesh(mesh)
    n = m.shape[axis]
    out = torch.empty((t.shape[0] * n,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _record("all_gather", t, out.shape, axis)
    if m.groups is None:
        if not _is_fake(t):
            # every rank's chunk a copy of this one's
            _dry_fill(lambda: out.view((n,) + tuple(t.shape)).copy_(
                t.unsqueeze(0).expand((n,) + tuple(t.shape))))
        return out
    dist.all_gather_into_tensor(out, t.contiguous(), group=m.groups[axis])
    return out


# ---------------------------------------------------------------------------
# per-leaf routing
# ---------------------------------------------------------------------------

def leaf_sync_route(shape: Sequence[int], dtype, axis_size: int,
                    min_size: int = 1 << 16) -> str:
    """``"compressed"`` (the S2FP8 all-gather leg) or ``"plain"`` (f32
    all-reduce) for one gradient leaf: plain when the dtype is not a
    float, the leaf is 0-d, it has fewer than ``min_size`` elements, or
    its size does not divide by ``axis_size``."""
    size = 1
    for d in shape:
        size *= d
    if not (isinstance(dtype, torch.dtype) and dtype.is_floating_point):
        return "plain"
    if len(shape) == 0:
        return "plain"
    if size < min_size:
        return "plain"
    if size % axis_size != 0:
        return "plain"
    return "compressed"


# ---------------------------------------------------------------------------
# axis level: the mesh-native train step's sync
# ---------------------------------------------------------------------------

def compressed_allreduce_axis(flat: torch.Tensor, axis_name: str,
                              axis_size: int,
                              backend: Optional[str] = None, *,
                              mesh=None) -> torch.Tensor:
    """SUM-all-reduce a 1-D f32 tensor over ``axis_name`` with the
    compressed legs: a bf16 reduce-scatter, this rank's shard quantized
    through the engine ``backend`` (exact stats of the shard; ``None``:
    the default engine), a uint8 all-gather of the payloads and an f32
    all-gather of the (alpha, beta) pairs, then one dequantize per
    chunk."""
    red = reduce_scatter(flat.to(torch.bfloat16), axis_name, mesh=mesh)
    be = nbackend.get_backend(backend)
    q = be.quantize(red.float())
    payloads = all_gather(q.payload.view(torch.uint8), axis_name,
                          mesh=mesh)
    abs_ = all_gather(q.ab.reshape(1, 2), axis_name, mesh=mesh)
    chunks = payloads.view(q.payload.dtype).reshape(axis_size, -1)
    return torch.cat([be.dequantize(S2FP8Tensor(chunks[i], abs_[i], q.fmt))
                      for i in range(axis_size)])


def grad_sync_axis(grads, axis_name: AxisName, axis_sizes: Dict[str, int],
                   *, mode: str = "s2fp8", min_size: int = 1 << 16,
                   backend: Optional[str] = None, skip=None, mesh=None):
    """SUM-reduce a gradient tree over the mesh axes ``axis_name``.

    ``mode="f32"``: every leaf an f32 all-reduce (float leaves promoted to
    f32 for the wire, cast back; in place on f32 leaves).
    ``mode="s2fp8"``: leaves routed by :func:`leaf_sync_route` over the
    last axis; compressible ones take the bf16 reduce-scatter + S2FP8
    all-gather legs (after an f32 all-reduce over the leading axes of a
    tuple), the rest the plain all-reduce.  ``skip``: a bool tree of
    ``grads``' structure; True leaves are returned untouched (FSDP
    gradients, already reduce-scattered to their owner)."""
    from repro_torch.parallel.sharding import _map
    if mode not in ("f32", "s2fp8"):
        raise ValueError(f"grad_sync mode must be 'f32' or 's2fp8', "
                         f"got {mode!r}")
    axes = _axes(axis_name)
    inner = axes[-1]

    def plain(g):
        if g.is_floating_point():
            return all_reduce(g.float(), axes, mesh=mesh).to(g.dtype)
        return all_reduce(g.clone(), axes, mesh=mesh)

    def sync(g, s=False):
        if s:
            return g
        if mode == "f32" or leaf_sync_route(
                tuple(g.shape), g.dtype, axis_sizes[inner],
                min_size) == "plain":
            return plain(g)
        flat = g.reshape(-1).float()
        if len(axes) > 1:
            flat = all_reduce(flat, axes[:-1], mesh=mesh)
        out = compressed_allreduce_axis(flat, inner, axis_sizes[inner],
                                        backend, mesh=mesh)
        return out.reshape(g.shape).to(g.dtype)

    if skip is not None:
        return _map(sync, grads, skip)
    return _map(sync, grads)


# ---------------------------------------------------------------------------
# FSDP param axis: gather-on-use / scatter-on-grad
# ---------------------------------------------------------------------------

class FSDPInfo(NamedTuple):
    """How to gather one FSDP-sharded leaf and return its gradient.
    ``lead_axes`` are the other batch axes (e.g. ``("pod",)``) whose
    contributions sum before the reduce-scatter over ``axis``;
    ``gather_f32`` is the step's f32 gather (so every fallback use takes
    the same gradient path); ``mesh`` names the process groups, passed
    explicitly because the gradient runs on the autograd engine's
    thread."""
    axis: str
    axis_size: int
    lead_axes: Tuple[str, ...]
    grad_mode: str
    grad_min_size: int
    grad_backend: Optional[str]
    gather_f32: Optional[Callable] = None
    mesh: object = None


def param_scatter_axis(g: torch.Tensor, info: FSDPInfo) -> torch.Tensor:
    """A full-size gradient leaf reduced back to the owner's shard: summed
    over the lead batch axes, then reduce-scattered over the fsdp axis
    along dim 0 (in bf16 where the leaf routes compressed under s2fp8
    sync, else f32)."""
    if info.lead_axes:
        g = all_reduce(g.contiguous().clone(), info.lead_axes,
                       mesh=info.mesh)
    if info.axis_size == 1:
        return g
    route = ("compressed" if info.grad_mode == "s2fp8" and leaf_sync_route(
        tuple(g.shape), g.dtype, info.axis_size,
        info.grad_min_size) == "compressed" else "plain")
    wire = torch.bfloat16 if route == "compressed" else torch.float32
    red = reduce_scatter(g.to(wire), info.axis, mesh=info.mesh)
    return red.to(g.dtype)


class _ParamGather(torch.autograd.Function):
    """f32 gather of an owner shard; backward: :func:`param_scatter_axis`."""

    @staticmethod
    def forward(ctx, shard, info):
        ctx.info = info
        return all_gather(shard.detach(), info.axis, mesh=info.mesh)

    @staticmethod
    def backward(ctx, g):
        return param_scatter_axis(g.contiguous(), ctx.info), None


def make_param_gather(info: FSDPInfo) -> Callable:
    """The differentiable f32 gather for one FSDP leaf configuration:
    forward all-gathers dim 0 (shard -> full leaf), backward
    reduce-scatters the gradient to the owner's shard."""
    def gather(shard):
        return _ParamGather.apply(shard, info)
    return gather


def param_gather_axis(p_shard: torch.Tensor, axis_name: str, *,
                      mesh=None) -> torch.Tensor:
    """Plain f32 gather of an FSDP shard along dim 0 (the forward leg
    only; the step uses :func:`make_param_gather`)."""
    return all_gather(p_shard, axis_name, mesh=mesh)


def payload_gather_axis(q_local: S2FP8Tensor, axis_name: str, *,
                        mesh=None) -> S2FP8Tensor:
    """All-gather an S2FP8-quantized FSDP shard into the full payload
    tensor (1 byte an element on the wire, as uint8); the stats ride
    along unchanged (every shard was quantized with the same leaf-global
    (alpha, beta))."""
    u8 = q_local.payload.view(torch.uint8)
    full = all_gather(u8, axis_name, mesh=mesh)
    return S2FP8Tensor(full.view(q_local.payload.dtype), q_local.ab,
                       q_local.fmt)


def _unwrap(x):
    if isinstance(x, FSDPPayloadParam):
        return x.full()
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    if isinstance(x, dict):
        return {k: _unwrap(v) for k, v in x.items()}
    return x


class FSDPPayloadParam:
    """A payload-eligible FSDP shard on its way into the loss function.
    It presents the full logical leaf (``shape``, ``dim()``, ``dtype``,
    ``device``); ``qdot_train`` consumes it in the payload GEMM's B slot
    (quantize at the owner with the leaf-global bank stats, 1-byte
    all-gather, dB reduce-scattered back).  Any other use — a torch
    function (``__torch_function__``), indexing, ``.T``, arithmetic, any
    other tensor method — takes the f32 gather (:meth:`full`), whose
    backward returns the same sharded gradient.  ``.to(dtype)`` /
    ``.float()`` stay wrapped (the cast runs on the shard: quantizing the
    cast shard is quantizing the cast leaf)."""

    def __init__(self, shard: torch.Tensor, info: FSDPInfo):
        self.shard = shard
        self.info = info

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.shard.shape[0] * self.info.axis_size,)
                          + tuple(self.shard.shape[1:]))

    @property
    def ndim(self) -> int:
        return self.shard.dim()

    def dim(self) -> int:
        return self.shard.dim()

    @property
    def dtype(self):
        return self.shard.dtype

    @property
    def device(self):
        return self.shard.device

    def full(self) -> torch.Tensor:
        """The f32 gather of the leaf (differentiable)."""
        if self.info.gather_f32 is None:
            return param_gather_axis(self.shard, self.info.axis,
                                     mesh=self.info.mesh)
        return self.info.gather_f32(self.shard)

    def to(self, *args, **kwargs):
        dtype = kwargs.pop("dtype", None)
        if dtype is None and len(args) == 1 and isinstance(args[0],
                                                           torch.dtype):
            dtype, args = args[0], ()
        if dtype is not None and not args and not kwargs:
            if dtype == self.dtype:
                return self
            return FSDPPayloadParam(self.shard.to(dtype), self.info)
        if dtype is not None:
            kwargs["dtype"] = dtype
        return self.full().to(*args, **kwargs)

    def float(self):
        return self.to(torch.float32)

    @property
    def T(self):
        return self.full().T

    def __getitem__(self, idx):
        return self.full()[idx]

    def __getattr__(self, name):
        if name.startswith("__") or name in ("shard", "info"):
            raise AttributeError(name)
        return getattr(self.full(), name)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*_unwrap(tuple(args)), **_unwrap(kwargs or {}))

    def __mul__(self, o):
        return self.full() * _unwrap(o)

    def __rmul__(self, o):
        return _unwrap(o) * self.full()

    def __add__(self, o):
        return self.full() + _unwrap(o)

    def __radd__(self, o):
        return _unwrap(o) + self.full()

    def __sub__(self, o):
        return self.full() - _unwrap(o)

    def __rsub__(self, o):
        return _unwrap(o) - self.full()

    def __truediv__(self, o):
        return self.full() / _unwrap(o)

    def __neg__(self):
        return -self.full()

    def __matmul__(self, o):
        return self.full() @ _unwrap(o)

    def __rmatmul__(self, o):
        return _unwrap(o) @ self.full()

    def __repr__(self):
        return (f"FSDPPayloadParam(shard={tuple(self.shard.shape)}, "
                f"full={tuple(self.shape)}, axis={self.info.axis!r}"
                f"x{self.info.axis_size})")


# ---------------------------------------------------------------------------
# mesh level: averaging wrappers over replicated inputs
# ---------------------------------------------------------------------------

def compressed_allreduce_1d(g: torch.Tensor, mesh, axis: str = "data",
                            backend: Optional[str] = None) -> torch.Tensor:
    """SUM-all-reduce a 1-D f32 tensor (len % axis size == 0) over
    ``axis`` with the compressed legs (:func:`compressed_allreduce_axis`)."""
    n = mesh.shape[axis]
    return compressed_allreduce_axis(g, axis, n, backend, mesh=mesh)


def compressed_grad_sync(grads, mesh, axis: str = "data",
                         min_size: int = 1 << 16,
                         backend: Optional[str] = None):
    """Average every leaf over ``axis``: compressible leaves
    (:func:`leaf_sync_route`) through the compressed all-reduce, the rest
    through a plain one (f32; integer leaves in their own dtype, summed
    and floor-divided by the axis size — the replicated copies' exact
    mean)."""
    from repro_torch.parallel.sharding import _map
    n = mesh.shape[axis]

    def sync_leaf(g):
        if leaf_sync_route(tuple(g.shape), g.dtype, n, min_size) == "plain":
            if not g.is_floating_point():
                return all_reduce(g.clone(), axis, mesh=mesh) // n
            out = all_reduce(g.float().clone(), axis, mesh=mesh) / n
            return out.to(g.dtype)
        flat = g.reshape(-1).float()
        out = compressed_allreduce_1d(flat, mesh, axis, backend) / n
        return out.reshape(g.shape).to(g.dtype)

    return _map(sync_leaf, grads)


# ---------------------------------------------------------------------------
# the model axis: tensor-parallel primitives
# ---------------------------------------------------------------------------

class TpSpec(NamedTuple):
    """How one contraction's operands and result lie over a mesh axis
    (the model axis; ``models/blocks.py`` builds them from the logical
    axes' splits).  ``a``, ``b``: ``"full"`` (every rank holds the whole
    operand) or ``"split"`` (the rank's slice of one of its dims);
    ``out``: ``"full"``, ``"split"``, or ``"partial"`` (a split contracted
    dim: each rank holds a partial sum, all-reduced in f32 before any
    truncation).  ``b_pick``: the index along ``b``'s dim 1 (a grouped
    K/V head) that the rank's query heads attend with, taken from the
    whole ``b`` after its truncation (GQA where the K/V heads do not
    split but the query heads do).

    A split tensor's S2FP8 stats are the whole tensor's (its partials
    combined over ``axis``); a cotangent follows :meth:`grad_state`."""
    axis: str
    a: str = "full"
    b: str = "split"
    out: str = "split"
    b_pick: Optional[int] = None

    def state(self, which: str) -> str:
        """``a``, ``b``, ``out`` (the value), or ``g`` (the cotangent of
        the output: split where the output is, whole after a partial
        output's all-reduce)."""
        if which == "g":
            return "split" if self.out == "split" else "full"
        return getattr(self, which)

    def grad_state(self, which: str) -> str:
        """The raw cotangent of operand ``which``: ``"partial"`` when the
        operand is whole and the output split (a sum over the split
        dim), ``"split"`` when the operand is, else ``"full"``."""
        st = getattr(self, which)
        if st == "split":
            return "split"
        return "partial" if self.out == "split" else "full"

    def split_axis(self, state: str) -> Optional[str]:
        """``axis`` for a split state (its stats take the whole tensor's),
        else None."""
        return self.axis if state == "split" else None


class _CopyIn(torch.autograd.Function):
    """Identity forward, all-reduce backward: a whole operand entering a
    contraction whose other operand is split gets its cotangent summed
    over the axis."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.axis,
                          mesh=ctx.mesh), None, None


class _ReduceOut(torch.autograd.Function):
    """All-reduce forward (partial sums over the axis), identity
    backward (the whole cotangent reaches every rank's partial)."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        return all_reduce(x.contiguous().clone(), axis, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_in(x: torch.Tensor, axis: str, *, mesh=None) -> torch.Tensor:
    """``x`` unchanged; its cotangent all-reduced over ``axis``."""
    return _CopyIn.apply(x, axis, mesh)


def reduce_out(x: torch.Tensor, axis: str, *, mesh=None) -> torch.Tensor:
    """Sum ``x`` over ``axis`` (every rank gets the sum); the cotangent
    passes unchanged."""
    return _ReduceOut.apply(x, axis, mesh)


def gather_dim(x: torch.Tensor, axis: str, dim: int, *, mesh=None
               ) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in axis order (no
    autograd)."""
    if dim == 0:
        return all_gather(x.contiguous(), axis, mesh=mesh)
    full = all_gather(x.movedim(dim, 0).contiguous(), axis, mesh=mesh)
    return full.movedim(0, dim).contiguous()


def scatter_dim(g: torch.Tensor, axis: str, dim: int, *, mesh=None
                ) -> torch.Tensor:
    """Sum ``g`` over ``axis`` and keep this rank's slice of ``dim`` (no
    autograd)."""
    if dim == 0:
        return reduce_scatter(g, axis, mesh=mesh)
    out = reduce_scatter(g.movedim(dim, 0).contiguous(), axis, mesh=mesh)
    return out.movedim(0, dim).contiguous()


class _GatherDim(torch.autograd.Function):
    """A stored slice gathered along ``dim`` over ``axis`` for use.
    Backward ``"reduce_scatter"``: the ranks of ``axis`` hold partial
    gradients (their rows of the batch): summed over ``lead`` first, then
    reduce-scattered back to the slice (f32).  ``"slice"``: the use is
    replicated over ``axis``, every rank holds the whole gradient, and
    keeps its own slice."""

    @staticmethod
    def forward(ctx, x, axis, dim, grad, lead, mesh):
        ctx.meta = (axis, dim, grad, lead, mesh, x.shape[dim], x.dtype)
        return gather_dim(x.detach(), axis, dim, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        axis, dim, grad, lead, mesh, n, dtype = ctx.meta
        m = _mesh(mesh)
        if grad == "slice":
            c = m.coords[axis]
            return (g.narrow(dim, c * n, n).contiguous(), None, None, None,
                    None, None)
        g = g.float()
        if lead:
            g = all_reduce(g.contiguous().clone(), lead, mesh=mesh)
        return (scatter_dim(g, axis, dim, mesh=mesh).to(dtype), None, None,
                None, None, None)


def gather_for_use(x: torch.Tensor, axis: str, dim: int, grad: str,
                   lead: Tuple[str, ...] = (), *, mesh=None
                   ) -> torch.Tensor:
    """Differentiable :class:`_GatherDim`: the whole of ``dim`` from this
    rank's slice; the gradient comes back by ``grad`` (``"slice"`` or
    ``"reduce_scatter"``)."""
    return _GatherDim.apply(x, axis, dim, grad, tuple(lead), mesh)
