"""Cost of a traced call, per device: FLOPs, bytes, collective bytes, peak
live bytes and the kernel calls (the port's counterpart of
``repro.roofline.hlo_cost``, which reads XLA's HLO; the port has none, so
it counts what a call dispatches).

    with trace_cost(args=(params, opt_state, batch)) as cost:
        step(params, opt_state, batch, 0)
    cost.flops, cost.bytes, cost.coll_bytes, cost.peak_bytes, cost.calls

The call may run on real tensors or on fake ones (``FakeTensorMode``, as
``launch/dryrun.py`` traces; meta tensors too); the same call counts the
same on both.  A ``TorchDispatchMode`` sees every aten op and the kernel
wrappers report each call (``kernels.observe``), whatever engine routed
it there, so no engine of its own is needed: a dry trace runs the
policy's engine on fake CPU tensors, where a kernel call makes outputs of
its plain version's shapes without running it (``FAKE_OUTPUTS``), and the
same step on the card counts the same calls as its launches.  Cost model,
per device:

  flops:  matrix products only, the reference's convention (dots and
          convs; elementwise work is not counted): the matmul-class aten
          ops as ``torch.utils.flop_counter`` counts them (plus ``mv`` and
          ``dot``), and each kernel call charged the products of the
          function it computes — a payload GEMM 2·M·N·K (times its batch),
          a flash forward 4·d and a flash backward 10·d per visible
          (query, key) pair and head (the backward's one recompute of the
          scores included).  The quantize family, the selective scan and
          the paged decode do no matrix product and charge none.  Inside a
          kernel call nothing else is counted, so a CPU run (where each
          wrapper takes its plain version) charges what the card's kernel
          does, not the plain version's inner ops.
  bytes:  every materialized op reads each tensor operand once and writes
          each result once; views, ``detach``, ``expand`` and allocations
          cost nothing (``hlo_cost``'s bitcast / reshape).  A kernel call
          reads its tensor inputs once and writes its outputs once (the
          bound model of PERF.md's kernel table).
  coll:   from ``collectives.recording()``, with the reference's
          multipliers: all-reduce 2x its result, all-gather 1x its result,
          reduce-scatter 1x its operand; by op (``coll``) and by mesh axis
          (``coll_axis``: ``model`` traffic apart from ``data``'s, a
          collective over several axes under their names joined by
          ``+``).
  peak:   live storage bytes, from the call's tensor arguments (``args``:
          resident throughout) and every storage an op or a kernel call
          allocates, freed when its last tensor dies (a weak reference to
          the storage itself, so autograd's saved tensors keep theirs
          alive); views and in-place ops share their input's storage.  The
          cyclic garbage collector is off during the trace, so a fake and
          a real run free at the same points.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import inspect
import time
from typing import Dict, List

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels
from repro_torch.core import collectives

COLL_MULT = {"all_reduce": 2.0, "all_gather": 1.0, "reduce_scatter": 1.0}

aten = torch.ops.aten

# allocations and aliasing ops that move no bytes (besides the view ops,
# which the schema marks)
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten._unsafe_view.default,
         aten.lift_fresh.default, aten.detach.default, aten.alias.default}


# metadata queries (a fake tensor dispatches some): no work
_META = {aten.sym_size.int, aten.sym_stride.int, aten.sym_numel.default,
         aten.sym_storage_offset.default, aten.is_contiguous.default,
         aten.is_contiguous.memory_format}


def _mv_flop(a, b, *args, out_val=None, **kwargs):
    return 2 * a.shape[0] * a.shape[1]


def _dot_flop(a, b, *args, out_val=None, **kwargs):
    return 2 * a.shape[0]


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    reg = dict(flop_registry)
    reg[aten.mv] = _mv_flop
    reg[aten.dot] = _dot_flop
    return reg


@functools.lru_cache(maxsize=4096)
def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a head attends to: query rows aligned to the end
    of the key axis, keys up to the row's position under ``causal``, the
    last ``window`` of them with a window (the flash kernels' mask)."""
    total = 0
    for r in range(sq):
        qpos = r + sk - sq
        hi = min(sk - 1, qpos) if causal else sk - 1
        lo = max(0, qpos - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def _gemm_flops(layout):
    def f(a):
        from repro_torch.kernels import ref
        m, k, n = ref.gemm_dims(layout, a["a"].shape, a["b"].shape)
        return 2.0 * m * k * n
    return f


def _batched_flops(a):
    from repro_torch.kernels import ref
    x, y = a["a"], a["b"]
    m, k, n = ref.gemm_dims(a["layout"], x.shape[1:], y.shape[1:])
    return 2.0 * max(x.shape[0], y.shape[0]) * m * k * n


def _flash_flops(per_pair: float, grouped: bool):
    def f(a):
        q, k = (a["qp"], a["kp"]) if grouped else (a["q"], a["k"])
        if grouped:                  # [BH, Sq, d], [BKV, Sk, d]
            heads, sq, d = q.shape
            sk = k.shape[1]
        else:                        # [B, H, Sq, d], [B, H, Sk, d]
            b, h, sq, d = q.shape
            heads, sk = b * h, k.shape[2]
        pairs = visible_pairs(sq, sk, bool(a["causal"]),
                              int(a["window"] or 0))
        return per_pair * d * heads * pairs
    return f


# the products each kernel's function does (module docstring)
KERNEL_FLOPS = {
    "qmatmul_nn": _gemm_flops("nn"),
    "qmatmul_nt": _gemm_flops("nt"),
    "qmatmul_tn": _gemm_flops("tn"),
    "qmatmul_batched": _batched_flops,
    "qflash_fwd": _flash_flops(4.0, True),
    "qflash_bwd": _flash_flops(10.0, True),
    "flash_fwd": _flash_flops(4.0, False),
}


# ---------------------------------------------------------------------------
# a kernel call on fake tensors: its outputs' shapes and dtypes, as its
# plain version returns them, without running the plain version (whose
# chunked loops would cost a dry trace most of its time)
# ---------------------------------------------------------------------------

def _empty(shape, dtype, like):
    return torch.empty(tuple(shape), dtype=dtype, device=like.device)


def _payload_dtype(fmt):
    from repro_torch.core import s2fp8
    return s2fp8.FMT_QDTYPE[fmt]


def _ab(like):
    return _empty((2,), torch.float32, like)


def _gemm_out(layout):
    def f(a):
        from repro_torch.kernels import ref
        m, _, n = ref.gemm_dims(layout, a["a"].shape, a["b"].shape)
        return _empty((m, n), torch.float32, a["a"])
    return f


def _batched_out(a):
    from repro_torch.kernels import ref
    x, y = a["a"], a["b"]
    _, go = ref.batched_dims(x.shape[0], y.shape[0], a["out_batch"])
    m, _, n = ref.gemm_dims(a["layout"], x.shape[1:], y.shape[1:])
    return _empty((go, m, n), torch.float32, x)


def _scan_out(a):
    x, bmat = a["x"], a["bmat"]
    b, _, di = x.shape
    y = _empty(x.shape, torch.float32, x)
    h = _empty((b, di, bmat.shape[-1]), torch.float32, x)
    return (y, h, None) if a["chunk_states"] else (y, h)


FAKE_OUTPUTS = {
    "quant_apply": lambda a: _empty(a["x"].shape, _payload_dtype(a["fmt"]),
                                    a["x"]),
    "truncate_apply": lambda a: _empty(a["x"].shape, a["x"].dtype, a["x"]),
    "dequant": lambda a: _empty(a["payload"].shape, torch.float32,
                                a["payload"]),
    "stats": lambda a: (_empty((3,), torch.float32, a["x"]), _ab(a["x"])),
    "quant": lambda a: (_empty(a["x"].shape, _payload_dtype(a["fmt"]),
                               a["x"]), _ab(a["x"])),
    "truncate_fused": lambda a: (_empty(a["x"].shape, a["x"].dtype, a["x"]),
                                 _ab(a["x"])),
    "qmatmul_nn": _gemm_out("nn"),
    "qmatmul_nt": _gemm_out("nt"),
    "qmatmul_tn": _gemm_out("tn"),
    "qmatmul_batched": _batched_out,
    "qflash_fwd": lambda a: (
        _empty(a["qp"].shape, torch.float32, a["qp"]),
        _empty(a["qp"].shape[:2], torch.float32, a["qp"])),
    "qflash_bwd": lambda a: (
        _empty(a["qp"].shape, torch.float32, a["qp"]),
        _empty(a["qp"].shape[:1] + a["kp"].shape[1:], torch.float32,
               a["qp"]),
        _empty(a["qp"].shape[:1] + a["kp"].shape[1:], torch.float32,
               a["qp"])),
    "flash_fwd": lambda a: _empty(a["q"].shape, a["q"].dtype, a["q"]),
    "paged_decode": lambda a: _empty(a["q"].shape, torch.float32, a["q"]),
    "selective_scan": _scan_out,
    "selective_scan_bwd": lambda a: tuple(
        _empty(a[k].shape, torch.float32, a[k])
        for k in ("x", "dt", "bmat", "cmat", "a", "d_skip")),
}


@functools.lru_cache(maxsize=None)
def _signature(fn):
    return inspect.signature(fn)


def _bound(fn, args, kwargs) -> dict:
    ba = _signature(fn).bind(*args, **kwargs)
    ba.apply_defaults()
    return ba.arguments


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors of nested tuples / lists / dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


@dataclasses.dataclass
class TraceCost:
    """What one traced call cost on one device (module docstring)."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_axis: Dict[str, float] = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    peak_bytes: int = 0
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    aten_ops: int = 0            # materialized ops outside kernel calls
    seconds: float = 0.0

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes

    def to_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "coll_bytes": self.coll_bytes, "coll": dict(self.coll),
                "coll_axis": dict(self.coll_axis),
                "argument_bytes": self.argument_bytes,
                "temp_bytes": self.temp_bytes,
                "peak_bytes": self.peak_bytes, "calls": dict(self.calls),
                "kernel_flops": dict(self.kernel_flops),
                "kernel_bytes": dict(self.kernel_bytes),
                "aten_ops": self.aten_ops, "seconds": self.seconds}


class _Counter(TorchDispatchMode):
    """Counts aten ops outside kernel calls and tracks live storages."""

    def __init__(self, cost: TraceCost):
        super().__init__()
        self.cost = cost
        self.flop_reg = _flop_registry()
        self.depth = 0                # > 0 inside a kernel wrapper
        self.live: Dict[int, tuple] = {}    # storage key -> (ref, bytes)
        self.live_bytes = 0           # an upper bound until swept

    # -- storages ----------------------------------------------------------
    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.live_bytes -= self.live.pop(k)[1]

    def _known(self, st) -> bool:
        ent = self.live.get(st._cdata)
        return ent is not None and not ent[0].expired()

    def add_storage(self, t: torch.Tensor, resident: bool = False) -> None:
        st = t.untyped_storage()
        if self._known(st):
            return
        key, nb = st._cdata, st.nbytes()
        if key in self.live:          # a freed storage's address, reused
            self.live_bytes -= self.live.pop(key)[1]
        if not resident and self.live_bytes + nb > self.cost.peak_bytes:
            self._sweep()             # only a new peak needs exact bytes
        self.live[key] = (StorageWeakRef(st), nb)
        self.live_bytes += nb
        if resident:
            self.cost.argument_bytes += nb
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.live_bytes)

    def _new_outputs(self, outs, ins) -> None:
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if t.untyped_storage()._cdata not in in_keys:
                self.add_storage(t)

    # -- aten ops ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.depth or func.namespace == "prim" or func in _META:
            return out
        cost = self.cost
        fl = self.flop_reg.get(func.overloadpacket)
        if fl is not None:
            cost.flops += fl(*args, **kwargs, out_val=out)
        if func.is_view or func in _FREE:
            return out
        cost.aten_ops += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        cost.bytes += sum(_nbytes(t) for t in ins + outs)
        self._new_outputs(outs, ins)
        return out

    # -- kernel calls ------------------------------------------------------
    def kernel(self, name, fn, args, kwargs):
        if self.depth:
            return fn(*args, **kwargs)
        named = _bound(fn, args, kwargs)
        ins = _tensors(list(named.values()))
        self.depth += 1
        try:
            if any(is_fake(t) or t.is_meta for t in ins):
                out = FAKE_OUTPUTS[name](named)
            else:
                out = fn(*args, **kwargs)
        finally:
            self.depth -= 1
        cost = self.cost
        outs = _tensors(out)
        nb = float(sum(_nbytes(t) for t in ins + outs))
        fl = KERNEL_FLOPS[name](named) if name in KERNEL_FLOPS else 0.0
        cost.calls[name] = cost.calls.get(name, 0) + 1
        cost.kernel_flops[name] = cost.kernel_flops.get(name, 0.0) + fl
        cost.kernel_bytes[name] = cost.kernel_bytes.get(name, 0.0) + nb
        cost.flops += fl
        cost.bytes += nb
        self._new_outputs(outs, ins)
        return out


@contextlib.contextmanager
def trace_cost(args=()):
    """Count the cost of the work done while open (module docstring);
    ``args``: the trees the call takes (params, optimizer state, batch,
    caches), resident for the whole call.  Yields the :class:`TraceCost`,
    complete when the context closes."""
    cost = TraceCost()
    counter = _Counter(cost)
    for t in _tensors(args):
        counter.add_storage(t, resident=True)
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    t0 = time.perf_counter()
    try:
        with collectives.recording() as records, \
                kernels.observe(counter.kernel), counter:
            yield cost
    finally:
        if was_enabled:
            gc.enable()
    cost.seconds = time.perf_counter() - t0
    for r in records:
        nbytes = (r["numel"] if r["op"] == "reduce_scatter"
                  else r["out_numel"]) * _itemsize(r["dtype"])
        traffic = nbytes * COLL_MULT[r["op"]]
        cost.coll[r["op"]] = cost.coll.get(r["op"], 0.0) + traffic
        axis = (r["axis"] if isinstance(r["axis"], str)
                else "+".join(r["axis"]))
        cost.coll_axis[axis] = cost.coll_axis.get(axis, 0.0) + traffic
        cost.coll_bytes += traffic


def _itemsize(dtype: str) -> int:
    return getattr(torch, dtype).itemsize

