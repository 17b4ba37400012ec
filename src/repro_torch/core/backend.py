"""Numerics-backend registry of the port: one interface, three engines.

Counterpart of ``repro.core.backend`` with its own table (nothing is
registered into the JAX package's registry):

  * ``"plain"``      — plain PyTorch (core/s2fp8.py + kernels/ref.py) on
    any device; the counterpart of the reference's ``RefBackend``;
  * ``"cuda"``       — the hand-written kernels through
    kernels/dispatch.py, with the exact stats of a tensor from the torch
    reduction (``s2fp8.compute_stats``); the counterpart of
    ``PallasBackend()`` (``stats_mode="exact"``);
  * ``"cuda_fused"`` — the same kernels, with every exact stats
    reduction in the stats kernels: ``compute_stats``,
    ``compute_stats_partials``, ``quantize(x)`` and ``truncate(x)``
    without stats run the stats, quantize-with-stats and fused truncate
    kernels; the counterpart of ``pallas_fused``
    (``stats_mode="fused"``).

The kernel wrappers launch the CUDA kernel for a CUDA tensor and take the
kernel's plain version for a CPU tensor, which is how the CPU tests run
the two kernel engines.  ``"auto"`` resolves to ``"cuda"``
(``default_backend_name``); ``register_backend`` adds an engine and
``available_backends`` lists the names.  (alpha, beta)
travel as f32 [2] tensors (core/s2fp8.py ``as_stats``).  ``quantize`` and
``truncate`` take ``stats=None`` as the reference's do: exact stats of
the tensor, reduced the engine's way.

Also here, as in the reference: ``bidir_truncate`` (the exact-stats
differentiable truncation per engine), ``truncate_delayed`` and the
deprecated ``DelayedStatsCache`` (delayed stats for eager callers), and
``plan_qdot_general`` and
``plan_einsum`` (how a contraction maps onto the 2-D or batched payload
GEMM layouts).
"""
from __future__ import annotations

import functools
import string
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import s2fp8
from repro_torch.core.s2fp8 import S2FP8Tensor


def all_reduce_stats_partials(partials, axis_name):
    """Combine per-rank (log_sum, log_max, count) stats partials over the
    mesh axis (or axes) ``axis_name``: sums and counts add, maxes max —
    exact global stats, not rank-averaged.  The sum and the count travel
    together in f64 (one all-reduce), the max in a second; the results
    come back f32, as the partials went in."""
    from repro_torch.core import collectives
    log_sum, log_max, count = partials
    sc = collectives.all_reduce(
        torch.stack([log_sum.double(), count.double()]), axis_name)
    mx = collectives.all_reduce(log_max.double().reshape(1), axis_name,
                                op="max")
    return sc[0].float(), mx[0].float(), sc[1].float()


def split_stats_partials(partials, axis):
    """Combine the (log_sum, log_max, count) partials of the ranks' slices
    of a tensor split over the mesh axis ``axis`` (the model axis) into
    the whole tensor's: every rank's triplet gathered in f64 and summed
    in axis order, the maxes maxed, so every rank ends with the same bits
    whatever the collective library's reduction order.  Back in f32, as
    the partials went in."""
    from repro_torch.core import collectives
    log_sum, log_max, count = partials
    row = torch.stack([log_sum.double(), count.double(),
                       log_max.double()]).reshape(1, 3)
    rows = collectives.all_gather(row, axis)
    s_, c_, m_ = rows[0, 0], rows[0, 1], rows[0, 2]
    for i in range(1, rows.shape[0]):
        s_, c_ = s_ + rows[i, 0], c_ + rows[i, 1]
        m_ = torch.maximum(m_, rows[i, 2])
    return s_.float(), m_.float(), c_.float()


def split_stats(be, x: torch.Tensor, fmt: str, axis: Optional[str]
                ) -> torch.Tensor:
    """Exact (alpha, beta) of ``x``'s whole tensor: its own when ``axis``
    is None, else of its slices over ``axis`` (``split_stats_partials``)."""
    if axis is None:
        return be.compute_stats(x, fmt=fmt)
    alpha, beta = s2fp8.stats_from_reduction(
        *split_stats_partials(be.compute_stats_partials(x), axis),
        s2fp8.FMT_TARGET_MAX[fmt])
    return torch.stack([alpha, beta])


class NumericsBackend:
    """Interface every engine implements.  ``stats`` is (alpha, beta) as an
    f32 [2] tensor or a pair: serving quantizes with frozen or calibrated
    stats, never with per-call ones.

    ``compute_stats(x)`` reduces over the tensor the caller holds (local:
    under a mesh, the rank's shard); ``compute_stats(x, axis_name=...)``
    all-reduces the raw partials over those mesh axes first (global: every
    rank gets the stats of the logical tensor)."""

    name = "abstract"

    def compute_stats_partials(self, x: torch.Tensor
                               ) -> Tuple[torch.Tensor, ...]:
        return s2fp8.compute_stats_partials(x)

    def compute_stats(self, x: torch.Tensor, *, fmt: str = "e5m2",
                      axis_name=None) -> torch.Tensor:
        """Exact (alpha, beta) of ``x`` for ``fmt``'s range, f32 [2]."""
        if axis_name is not None:
            alpha, beta = s2fp8.stats_from_reduction(
                *all_reduce_stats_partials(self.compute_stats_partials(x),
                                           axis_name),
                s2fp8.FMT_TARGET_MAX[fmt])
            return torch.stack([alpha, beta])
        return s2fp8.compute_stats(x, s2fp8.FMT_TARGET_MAX[fmt])

    def quantize(self, x: torch.Tensor, *, stats=None,
                 fmt: str = "e5m2") -> S2FP8Tensor:
        """Payload of ``x`` under ``stats``, or under the exact stats of
        ``x`` when ``stats`` is None."""
        raise NotImplementedError

    def dequantize(self, t: S2FP8Tensor, dtype=torch.float32) -> torch.Tensor:
        return s2fp8.dequantize(t, dtype)

    def truncate(self, x: torch.Tensor, *, stats=None,
                 fmt: str = "e5m2") -> torch.Tensor:
        """Eq. 5 round trip of ``x`` under ``stats``, or under the exact
        stats of ``x`` when ``stats`` is None; in ``x``'s dtype."""
        raise NotImplementedError

    def qmatmul(self, a: S2FP8Tensor, b: S2FP8Tensor, *, layout: str = "nn",
                epilogue_stats=None, fmt: str = "e5m2") -> torch.Tensor:
        """Payload GEMM on 2-D payloads; ``epilogue_stats`` fuses the output
        site's Eq. 5 truncation (on the ``fmt`` grid)."""
        raise NotImplementedError

    def qmatmul_batched(self, a: S2FP8Tensor, b: S2FP8Tensor, *,
                        layout: str = "nn", out_batch: Optional[int] = None,
                        epilogue_stats=None, fmt: str = "e5m2"
                        ) -> torch.Tensor:
        """Batched payload GEMM on 3-D payloads ``[Ga, ., .]`` x ``[Gb, .,
        .]``: combined batch ``G = max(Ga, Gb)``, operand slice ``g % Gx``
        for step ``g`` (the ``becd,edf`` broadcast), ``out_batch`` (default
        ``G``) < ``G`` sums the ``G // out_batch`` groups into one output
        slice (the dW of a broadcast operand); ``epilogue_stats`` as in
        :meth:`qmatmul`."""
        raise NotImplementedError

    def __repr__(self):
        return f"<NumericsBackend {self.name!r}>"


class PlainBackend(NumericsBackend):
    """Plain PyTorch engine (the reference's ``ref`` counterpart)."""

    name = "plain"

    def quantize(self, x, *, stats=None, fmt="e5m2"):
        return s2fp8.quantize(x, stats=stats, fmt=fmt)

    def truncate(self, x, *, stats=None, fmt="e5m2"):
        from repro_torch.kernels import ref
        return ref.s2fp8_truncate_ref(x, stats=stats, fmt=fmt)

    def qmatmul(self, a, b, *, layout="nn", epilogue_stats=None, fmt="e5m2"):
        from repro_torch.kernels import ref
        oab = (None if epilogue_stats is None
               else s2fp8.as_stats(epilogue_stats, a.payload.device))
        return ref.s2fp8_matmul_ref(a.payload, a.ab, b.payload, b.ab, oab,
                                    layout=layout, fmt=fmt)

    def qmatmul_batched(self, a, b, *, layout="nn", out_batch=None,
                        epilogue_stats=None, fmt="e5m2"):
        from repro_torch.kernels import ref
        oab = (None if epilogue_stats is None
               else s2fp8.as_stats(epilogue_stats, a.payload.device))
        return ref.s2fp8_matmul_batched_ref(
            a.payload, a.ab, b.payload, b.ab, oab, layout=layout,
            out_batch=out_batch, fmt=fmt)


class CudaBackend(NumericsBackend):
    """Hand-written CUDA kernels (the reference's ``PallasBackend``).

    ``stats_mode``: "exact" (``cuda``) takes the exact stats of a tensor
    from the torch reduction, so they are bit for bit the plain engine's;
    "fused" (``cuda_fused``) takes them from the stats kernels (a
    deterministic f64-summed reduction, float-tolerance parity)."""

    name = "cuda"

    def __init__(self, *, stats_mode: str = "exact",
                 name: Optional[str] = None):
        if stats_mode not in ("exact", "fused"):
            raise ValueError(f"stats_mode must be 'exact' or 'fused', "
                             f"got {stats_mode!r}")
        self.stats_mode = stats_mode
        if name is not None:
            self.name = name

    def compute_stats_partials(self, x):
        if self.stats_mode == "exact":
            return super().compute_stats_partials(x)
        from repro_torch.kernels import dispatch
        return dispatch.stats_partials_nd(x)

    def compute_stats(self, x, *, fmt="e5m2", axis_name=None):
        if self.stats_mode == "exact" or axis_name is not None:
            return super().compute_stats(x, fmt=fmt, axis_name=axis_name)
        from repro_torch.kernels import dispatch
        return dispatch.stats_nd(x, s2fp8.FMT_TARGET_MAX[fmt])

    def quantize(self, x, *, stats=None, fmt="e5m2"):
        from repro_torch.kernels import dispatch
        if stats is None and self.stats_mode == "exact":
            stats = self.compute_stats(x, fmt=fmt)
        payload, ab = dispatch.quant_nd(x, stats, fmt)
        return S2FP8Tensor(payload, ab, fmt)

    def dequantize(self, t, dtype=torch.float32):
        from repro_torch.kernels import dispatch
        return dispatch.dequant_nd(t.payload, t.ab, dtype)

    def truncate(self, x, *, stats=None, fmt="e5m2"):
        from repro_torch.kernels import dispatch
        return dispatch.truncate_nd(x, stats, fmt,
                                    fused_stats=self.stats_mode == "fused")

    def qmatmul(self, a, b, *, layout="nn", epilogue_stats=None, fmt="e5m2"):
        from repro_torch.kernels import dispatch
        return dispatch.qmatmul_nd(a.payload, a.ab, b.payload, b.ab,
                                   layout=layout,
                                   epilogue_stats=epilogue_stats, fmt=fmt)

    def qmatmul_batched(self, a, b, *, layout="nn", out_batch=None,
                        epilogue_stats=None, fmt="e5m2"):
        from repro_torch.kernels import dispatch
        return dispatch.qmatmul_batched_nd(
            a.payload, a.ab, b.payload, b.ab, layout=layout,
            out_batch=out_batch, epilogue_stats=epilogue_stats, fmt=fmt)


BACKENDS: Dict[str, NumericsBackend] = {}


def register_backend(name: str, backend: NumericsBackend,
                     overwrite: bool = False) -> NumericsBackend:
    """Add ``backend`` to the registry under ``name``; a taken name raises
    unless ``overwrite``."""
    if name in BACKENDS and not overwrite:
        raise ValueError(f"backend {name!r} already registered; "
                         f"pass overwrite=True to replace it")
    BACKENDS[name] = backend
    return backend


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(BACKENDS))


def default_backend_name() -> str:
    """The engine ``None`` / ``"auto"`` resolve to: the kernels."""
    return "cuda"


def get_backend(name: Optional[str] = None) -> NumericsBackend:
    """Resolve a backend by name; ``None``/"auto" is the ``cuda`` engine."""
    if name is None or name == "auto":
        name = default_backend_name()
    try:
        return BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown numerics backend {name!r}; "
                       f"registered: {available_backends()}") from None


register_backend("plain", PlainBackend())
register_backend("cuda", CudaBackend())
register_backend("cuda_fused", CudaBackend(stats_mode="fused",
                                           name="cuda_fused"))


# ---------------------------------------------------------------------------
# differentiable exact-stats truncation per engine (reference backend.py:555)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def bidir_truncate_split(backend: Optional[str], fmt: str, axis: str):
    """:func:`bidir_truncate` of a tensor split over the mesh axis
    ``axis``: the forward value and the cotangent each truncated with the
    whole tensor's exact stats (``split_stats``)."""

    def trunc(x):
        be = get_backend(backend)
        return be.truncate(x, stats=split_stats(be, x, fmt, axis), fmt=fmt)

    class _BidirSplit(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return trunc(x)

        @staticmethod
        def backward(ctx, g):
            return trunc(g)

    return _BidirSplit.apply


@functools.lru_cache(maxsize=None)
def bidir_truncate(backend: Optional[str] = None, fmt: str = "e5m2"):
    """Eq. 5 with fresh exact stats on the forward value AND on the
    cotangent, through the named engine (one callable per (engine,
    format)): ``truncate`` without stats, as the reference calls it."""

    def trunc(x):
        return get_backend(backend).truncate(x, fmt=fmt)

    class _Bidir(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return trunc(x)

        @staticmethod
        def backward(ctx, g):
            return trunc(g)

    return _Bidir.apply


# ---------------------------------------------------------------------------
# delayed stats (reference backend.py:580-634)
# ---------------------------------------------------------------------------

def truncate_delayed(x: torch.Tensor, stats, *, refresh: bool = False,
                     backend: Optional[str] = None, fmt: str = "e5m2"):
    """Functional delayed-stats truncation -> ``(truncated, stats_used)``.
    The caller threads ``stats_used`` into its next step and passes
    ``refresh=True`` every k steps to recompute them; ``stats=None``
    always refreshes."""
    be = get_backend(backend)
    if refresh or stats is None:
        stats = be.compute_stats(x, fmt=fmt)
    return be.truncate(x, stats=stats, fmt=fmt), stats


class DelayedStatsCache:
    """Deprecated shim over :class:`repro_torch.core.statsbank.
    HostStatsBank` (the same semantics): the old constructor, ``truncate``,
    ``clear`` and the ``_stats`` / ``_last_refresh`` views, with a
    ``DeprecationWarning`` on construction."""

    def __init__(self, backend: Optional[str] = None,
                 refresh_every: int = 16, fmt: str = "e5m2"):
        import warnings
        warnings.warn(
            "DelayedStatsCache is deprecated; use "
            "repro_torch.core.statsbank.HostStatsBank (same semantics, "
            "shared with the carried StatsBank)", DeprecationWarning,
            stacklevel=2)
        from repro_torch.core import statsbank
        self._impl = statsbank.HostStatsBank(
            backend=backend, refresh_every=refresh_every, fmt=fmt)
        self.backend = backend
        self.refresh_every = refresh_every
        self.fmt = fmt

    def truncate(self, x: torch.Tensor, key: str, step: int) -> torch.Tensor:
        return self._impl.truncate(x, key, step)

    def clear(self) -> None:
        self._impl.clear()

    @property
    def _stats(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        return {k: (e["alpha"], e["beta"]) for k, e in self._impl.bank.items()}

    @property
    def _last_refresh(self) -> Dict[str, int]:
        return {k: int(e["last"]) for k, e in self._impl.bank.items()}


# ---------------------------------------------------------------------------
# contraction planning (reference backend.py:159-349)
# ---------------------------------------------------------------------------

class QdotPlan(NamedTuple):
    """How one contraction maps onto the payload GEMM kernels: the kernel
    layout, the operands' reshape targets and the final output shape.
    ``batch == 1`` is a 2-D GEMM (2-D shapes); ``batch > 1`` makes
    ``a2_shape`` a ``(G, ., .)`` at the full combined batch and ``b2_shape``
    a ``(Gb, ., .)`` with ``Gb | G`` — ``Gb < G`` broadcasts B across the
    leading ``G // Gb`` groups (the ``becd,edf`` family)."""

    layout: str
    a2_shape: Tuple[int, ...]
    b2_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    batch: int = 1
    b_batch: int = 1


def _prod(dims) -> int:
    p = 1
    for d in dims:
        p *= d
    return p


def _plan_from_parts(layout: str, batch_dims, b_batch_dims, m: int, k: int,
                     n: int, out_shape) -> Optional[QdotPlan]:
    """A QdotPlan from the decomposed contraction: combined batch dims (all
    of A's leading dims), B's stored batch dims (a trailing subset),
    per-slice (m, k, n), and the logical output shape."""
    g, gb = _prod(batch_dims), _prod(b_batch_dims)
    if 0 in (g, gb, m, k, n):
        return None                      # degenerate sizes: no kernel path
    if layout == "nn":
        a2, b2 = (m, k), (k, n)
    elif layout == "nt":
        a2, b2 = (m, k), (n, k)
    else:
        a2, b2 = (k, m), (k, n)
    if g == 1:
        return QdotPlan(layout, a2, b2, tuple(out_shape))
    return QdotPlan(layout, (g,) + a2, (gb,) + b2, tuple(out_shape), g, gb)


def plan_qdot_general(a_shape, b_shape, dimension_numbers
                      ) -> Optional[QdotPlan]:
    """Map a dot_general onto a payload GEMM, or None when unsupported.

    One contracting dim per operand at the boundary of its free dims (the
    rest flatten contiguously), and batch dims — if any — leading and in
    order on both operands.  The output follows the dot_general
    convention ``batch + a_free + b_free``.  Covers the dense
    ``...k,kn->...n`` GEMMs ("nn"), the tied LM head ``x . E^T`` ("nt"),
    ``k...,kn`` ("tn") and their batched forms; (first, last) on (a, b) —
    the "tt" case — has no kernel layout and gives None."""
    (ca, cb), (batch_a, batch_b) = dimension_numbers
    if len(ca) != 1 or len(cb) != 1:
        return None
    nb = len(batch_a)
    if tuple(batch_a) != tuple(range(nb)) or \
            tuple(batch_b) != tuple(range(nb)):
        return None
    if tuple(a_shape[:nb]) != tuple(b_shape[:nb]):
        return None
    ca, cb = ca[0], cb[0]
    if ca not in (nb, len(a_shape) - 1) or cb not in (nb, len(b_shape) - 1):
        return None
    a_last = ca == len(a_shape) - 1
    b_first = cb == nb
    if not a_last and not b_first:
        return None                      # "tt": no layout variant
    k = a_shape[ca]
    if k != b_shape[cb]:
        return None
    a_rest = tuple(d for i, d in enumerate(a_shape) if i >= nb and i != ca)
    b_rest = tuple(d for i, d in enumerate(b_shape) if i >= nb and i != cb)
    layout = "nn" if (a_last and b_first) else ("nt" if a_last else "tn")
    batch = tuple(a_shape[:nb])
    return _plan_from_parts(layout, batch, batch, _prod(a_rest), k,
                            _prod(b_rest), batch + a_rest + b_rest)


def plan_einsum(spec: str, a_shape, b_shape) -> Optional[QdotPlan]:
    """Map a two-operand einsum onto a payload GEMM, or None.

    The family the kernels execute, as the reference's:

      * exactly one contracted label, first or last among each operand's
        non-batch labels (no "tt", no multi-label contraction, no
        sum-over-free);
      * B's labels are ``shared-batch + free/contract``; A's are ``lead +
        shared-batch + free/contract`` where ``lead`` are free labels only
        (they broadcast B — the ``becd,edf`` family);
      * the output is exactly ``lead + shared + a_free + b_free``, the
        order the batched GEMM produces, so the plan is pure reshapes.

    This covers the dense ``bsd,df->bsf`` family, the MoE expert einsums
    ``ecd,edf->ecf`` / ``becd,edf->becf`` and the attention contractions
    ``bkgqd,bksd->bkgqs`` / ``bkgqs,bksd->bkgqd``."""
    if "->" not in spec:
        return None
    lhs, lo = spec.replace(" ", "").split("->")
    parts = lhs.split(",")
    if len(parts) != 2:
        return None
    la, lb = parts
    if "." in lb:
        return None                      # ellipsis rhs: ambiguous layout
    if "..." in la:
        # concretize "..." with fresh labels, shared between lhs and out
        n_ell = len(a_shape) - (len(la) - 3)
        if n_ell < 0 or "..." not in lo:
            return None
        fresh = "".join(c for c in string.ascii_letters
                        if c not in spec)[:n_ell]
        if len(fresh) != n_ell:
            return None
        la = la.replace("...", fresh)
        lo = lo.replace("...", fresh)
    if "." in la + lo or len(la) != len(a_shape) or len(lb) != len(b_shape):
        return None
    if len(set(la)) != len(la) or len(set(lb)) != len(lb) \
            or len(set(lo)) != len(lo):
        return None
    sa, sb, so = set(la), set(lb), set(lo)
    if not so <= (sa | sb):
        return None
    contract = (sa & sb) - so
    if len(contract) != 1:
        return None
    k_lab = contract.pop()
    if (sa - {k_lab}) - so or (sb - {k_lab}) - so:
        return None                      # sum-over-free: not a pure GEMM
    shared = "".join(c for c in la if c in sb and c != k_lab)
    if not lb.startswith(shared):
        return None
    rb = lb[len(shared):]
    if shared:
        i0 = la.index(shared[0])
        if la[i0:i0 + len(shared)] != shared:
            return None
        lead, ra = la[:i0], la[i0 + len(shared):]
        if any(c in sb for c in lead):
            return None                  # shared labels must be contiguous
    else:
        lead, ra = "", la
    fa = "".join(c for c in ra if c != k_lab)
    fb = "".join(c for c in rb if c != k_lab)
    if ra not in (fa + k_lab, k_lab + fa) or rb not in (k_lab + fb, fb + k_lab):
        return None
    if lo != lead + shared + fa + fb:
        return None
    a_last, b_first = ra.endswith(k_lab), rb.startswith(k_lab)
    if not a_last and not b_first:
        return None                      # "tt"
    dims = dict(zip(la, a_shape))
    for c, d in zip(lb, b_shape):
        if dims.setdefault(c, d) != d:
            return None
    layout = "nn" if (a_last and b_first) else ("nt" if a_last else "tn")
    return _plan_from_parts(
        layout, tuple(dims[c] for c in lead + shared),
        tuple(dims[c] for c in shared),
        _prod(dims[c] for c in fa), dims[k_lab], _prod(dims[c] for c in fb),
        tuple(dims[c] for c in lo))
